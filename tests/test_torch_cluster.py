"""The PyTorch port's proofs-on LocalCluster survey against the JAX
reference, on the CPU.

The copied host modules (tiles, query, topology layout, skipchain,
proof envelopes, transcripts), the stats encoders, the canonical
aggregate, the aggregation and key-switch proofs, the Schnorr envelopes
and the cluster: keys from one seed, a proofs-on `mean` survey through
two VNs with its audit block, a tampered payload, kernel faults that
must propagate, and a proofs-off `log_reg` survey against the reference's
gradient descent. The reference's crypto reaches
drynx_tpu/crypto/pallas_ops.py, which does not import under this jax, so
the module-scoped `reference` fixture installs the `jax.enable_x64`
stand-in of tests/test_torch_survey.py while this module runs; at teardown
it restores the attribute and forgets every reference module imported
under it. The port's plain versions run on one torch thread here (beside
JAX's threads torch's pool makes them 2-3x slower), in inference mode
where no gradient is taken.
"""
import collections
import contextlib
import dataclasses
import importlib.util
import pickle
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drynx_tpu.crypto import params, refimpl
from drynx_tpu_torch import compilecache as cc
from drynx_tpu_torch.crypto import cuda_ops, cuda_pairing
from drynx_tpu_torch.crypto import curve as TC
from drynx_tpu_torch.crypto import elgamal as TE
from drynx_tpu_torch import flagship as TFL
from drynx_tpu_torch.encoding import stats as TST
from drynx_tpu_torch.encoding import tiles as TTI
from drynx_tpu_torch.models import logreg as TLR
from drynx_tpu_torch.proofs import aggregation as TAG
from drynx_tpu_torch.proofs import keyswitch as TKS
from drynx_tpu_torch.proofs import range_proof as TRP
from drynx_tpu_torch.proofs import requests as TRQ
from drynx_tpu_torch.proofs import schnorr as TSCH
from drynx_tpu_torch.proofs.safe_pickle import safe_loads
from drynx_tpu_torch.server import transcript as TTR
from drynx_tpu_torch.service import query as TQ
from drynx_tpu_torch.service import service as TSV
from drynx_tpu_torch.service import skipchain as TSK
from drynx_tpu_torch.service import store as TSTORE
from drynx_tpu_torch.service import topology as TTOP
from drynx_tpu_torch.service.api import DrynxClient
from drynx_tpu_torch.utils import cuda_build
from drynx_tpu_torch.utils.cuda_build import KernelError

ROOT = Path(__file__).resolve().parent.parent
OPS_NO_PROOF = ["sum", "mean", "variance", "frequency_count", "min", "max",
                "union", "inter", "bool_OR", "bool_AND"]
SEED = 3
# the proofs-on survey: 2 CNs, 2 DPs, 2 VNs, mean over [0, 15], ranges
# (16, 3); 2 envelopes of each of the 3 proof types reach each VN
N_CNS, N_DPS, N_VNS, U, L = 2, 2, 2, 16, 3
ROWS = 6


@contextlib.contextmanager
def _x64(flag=True):
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", bool(flag))
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


def _load(name, rel):
    """A reference module loaded from its file, without its package's
    __init__ (drynx_tpu/server/__init__.py imports the whole scheduler)."""
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def reference():
    """The reference's modules, importable and runnable on this jax while
    this module's tests run (see the module docstring)."""
    saved, threads = jax.enable_x64, torch.get_num_threads()
    before = set(sys.modules)
    jax.enable_x64 = _x64
    torch.set_num_threads(1)
    try:
        from drynx_tpu.crypto import elgamal, pallas_ops
        from drynx_tpu.encoding import stats, tiles
        from drynx_tpu.models import logreg
        from drynx_tpu.proofs import (aggregation, keyswitch, requests,
                                      schnorr)
        from drynx_tpu.service import (query, service, skipchain, store,
                                       topology)
        assert not pallas_ops.available()
        yield SimpleNamespace(
            elgamal=elgamal, stats=stats, tiles=tiles, logreg=logreg,
            aggregation=aggregation, keyswitch=keyswitch, requests=requests,
            schnorr=schnorr, query=query, service=service,
            skipchain=skipchain, store=store, topology=topology,
            transcript=_load("_reference_transcript",
                             "drynx_tpu/server/transcript.py"))
    finally:
        jax.enable_x64 = saved
        torch.set_num_threads(threads)
        for name in sorted(set(sys.modules) - before, reverse=True):
            if name.startswith("drynx_tpu."):
                parent, _, attr = name.rpartition(".")
                sys.modules.pop(name)
                if hasattr(sys.modules.get(parent), attr):
                    delattr(sys.modules[parent], attr)


def _count_wrapper_calls(mp, rows=None) -> dict:
    """Count the calls of every kernel wrapper, by kernel: on the CPU the
    counts that the wrappers keep in `LAUNCHES` on the card; with `rows`
    (a Counter) also each call's (kernel, rows), as `cuda_build.
    launch_rows` reads them for `LAUNCH_ROWS`."""
    counts = {}
    for mod in (cuda_ops, cuda_pairing):
        for name in mod.LAUNCHES:
            def counted(*a, _fn=getattr(mod, f"{name}_flat"), _name=name,
                        **k):
                counts[_name] += 1
                if rows is not None:
                    rows[(_name, cuda_build.launch_rows(_name, a))] += 1
                return _fn(*a, **k)
            counts[name] = 0
            mp.setattr(mod, f"{name}_flat", counted)
    return counts


def _chip_smoke():
    return _load("chip_smoke", "chip_smoke.py")


@pytest.fixture(scope="module")
def survey(reference):
    """One proofs-on `mean` survey on the port's cluster after the warm-up
    registry's pass for its shape (on the CPU: the tables), its kernel
    wrapper calls counted with their rows, and the cold events of the
    warm-up and of the survey."""
    cluster = TSV.LocalCluster(n_cns=N_CNS, n_dps=N_DPS, n_vns=N_VNS,
                               seed=SEED, dlog_limit=300, device="cpu")
    rng = np.random.default_rng(SEED)
    data = [rng.integers(0, 16, size=ROWS) for _ in range(N_DPS)]
    for dp, x in zip(cluster.dps.values(), data):
        dp.data = x
    sq = cluster.generate_survey_query("mean", query_min=0, query_max=15,
                                       proofs=1, ranges=[(U, L)] * 2)
    profile = cc.query_profile(cluster, sq.query)
    rows = collections.Counter()
    with pytest.MonkeyPatch.context() as mp, torch.inference_mode():
        mark = cc.COLD_EVENTS.mark()
        warm = cc.precompile(profile, cluster=cluster,
                             stats=cc.CompileStats(), log=lambda m: None)
        warm_events = cc.COLD_EVENTS.since(mark)
        sig_builds = dict(TRP.SIG_BUILD_COUNTS)
        counts = _count_wrapper_calls(mp, rows)
        mark = cc.COLD_EVENTS.mark()
        res = cluster.run_survey(sq, seed=SEED)
        survey_events = cc.COLD_EVENTS.since(mark)
    yield SimpleNamespace(cluster=cluster, sq=sq, res=res, data=data,
                          counts=dict(counts), rows=rows, profile=profile,
                          warm=warm, warm_events=warm_events,
                          survey_events=survey_events,
                          sig_builds=(sig_builds,
                                      dict(TRP.SIG_BUILD_COUNTS)))
    cluster.close()


# ---------------------------------------------------------------------------
# (a) copied modules: constants and bytes
# ---------------------------------------------------------------------------

def test_tiles_match_reference(reference):
    R = reference.tiles
    assert (TTI.DEFAULT_TILE, TTI.TILE_THRESHOLD, TTI.ENV_TILE) == (
        R.DEFAULT_TILE, R.TILE_THRESHOLD, R.ENV_TILE)
    for n in (0, 1, 7, 4096, 8192, 8193, 20000):
        assert TTI.auto_tile(n) == R.auto_tile(n)
        for t in (None, 0, 3, 4096):
            mine, ref = TTI.plan_tiles(n, t), R.plan_tiles(n, t)
            assert (mine.n, mine.tile, mine.tiles) == (ref.n, ref.tile,
                                                      ref.tiles)
            assert mine.peak_mask_elems(5) == ref.peak_mask_elems(5)


def test_query_model_matches_reference(reference):
    R = reference.query
    assert TQ.VALID_OPS == R.VALID_OPS
    assert TQ.OBFUSCATION_OPS == R.OBFUSCATION_OPS
    for op in TQ.VALID_OPS[:-1]:
        mine = TQ.choose_operation(op, 2, 9, dims=3, cutting_factor=2)
        ref = R.choose_operation(op, 2, 9, dims=3, cutting_factor=2)
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    p = TLR.LRParams(n_features=8)
    mine = TQ.choose_operation("log_reg", lr_params=p)
    ref = R.choose_operation("log_reg", lr_params=reference.logreg.LRParams(
        n_features=8))
    assert (mine.nbr_input, mine.nbr_output) == (ref.nbr_input,
                                                  ref.nbr_output) == (9, 90)
    for proofs, ranges, vns in ((1, [(16, 3)] * 2, ["vn0"]),
                                (1, None, []), (0, [(16, 3)] * 2, ["vn0"]),
                                (0, None, [])):
        sqs = []
        for M in (TQ, R):
            q = M.Query(operation=M.choose_operation("mean"), ranges=ranges,
                        proofs=proofs, sigs_present=ranges is not None)
            sqs.append(M.SurveyQuery(
                survey_id="s", query=q, server_ids=["cn0", "cn1"],
                server_to_dp={"cn0": ["dp0"], "cn1": ["dp1"]}, vn_ids=vns,
                threshold=1.0 * proofs, range_proof_threshold=1.0 * proofs))
        assert TQ.check_parameters(sqs[0], False) == R.check_parameters(
            sqs[1], False)
        assert TQ.query_to_proofs_nbrs(sqs[0]) == R.query_to_proofs_nbrs(
            sqs[1])


def test_topology_layout_matches_reference(reference):
    R = reference.topology
    assert (TTOP.ENV_TOPOLOGY, TTOP.ENV_FANOUT) == (R.ENV_TOPOLOGY,
                                                   R.ENV_FANOUT)
    assert TTOP.topology_mode() == R.topology_mode()
    for n in range(1, 70):
        b = TTOP.tree_fanout(n)
        assert b == R.tree_fanout(n)
        assert TTOP.roots(n, b) == R.roots(n, b)
        assert TTOP.depth(n, b) == R.depth(n, b)
        for i in range(n):
            assert TTOP.children(i, n, b) == R.children(i, n, b)
            assert TTOP.parent(i, b) == R.parent(i, b)
            assert TTOP.subtree(i, n, b) == R.subtree(i, n, b)
    order = [f"n{i}" for i in range(9)]
    alive = ["n7", "n1", "n4"]
    assert TTOP.survivor_layout(order, alive) == R.survivor_layout(order,
                                                                   alive)


def test_skipchain_blocks_and_store_layout_match_reference(reference,
                                                            tmp_path):
    R = reference.skipchain
    data = dict(survey_id="s1", sample_time=12.5,
                bitmap={"vn1:s1/range/dp0/x": 1, "vn0:s1/keyswitch/cn0/y": 0})
    mine = TSK.Block(3, "ab" * 32, TSK.DataBlock(**data))
    ref = R.Block(3, "ab" * 32, R.DataBlock(**data))
    assert mine.hash() == ref.hash()
    assert mine.to_bytes() == ref.to_bytes()
    assert mine.data.canonical() == ref.data.canonical()
    # a chain over the port's store: the reference's block hashes, and the
    # reference's pure-Python file layout (length-prefixed records)
    db = TSTORE.ProofDB(str(tmp_path / "vn.db"))
    chain = TSK.SkipChain(db)
    b0 = chain.append(TSK.DataBlock(**data))
    b1 = chain.append(TSK.DataBlock(**{**data, "survey_id": "s2"}))
    r0 = R.Block(0, "", R.DataBlock(**data))
    r1 = R.Block(1, r0.hash(), R.DataBlock(**{**data, "survey_id": "s2"}))
    assert (b0.hash(), b1.hash()) == (r0.hash(), r1.hash())
    assert chain.validate() and len(chain) == 2
    want = b""
    for k, v in ((b"chain/block/0", b0.to_bytes()), (b"chain/length", b"1"),
                 (b"chain/block/1", b1.to_bytes()), (b"chain/length", b"2")):
        want += len(k).to_bytes(4, "little") + len(v).to_bytes(
            4, "little") + k + v
    assert (tmp_path / "vn.db").read_bytes() == want
    again = TSK.SkipChain(TSTORE.ProofDB(str(tmp_path / "vn.db")))
    assert len(again) == 2 and again.latest().hash() == b1.hash()
    ck = TSTORE.SurveyCheckpoint(survey_id="s1").enter("collect")
    rk = reference.store.SurveyCheckpoint(survey_id="s1").enter("collect")
    assert ck.to_bytes() == rk.to_bytes()


def test_proof_envelopes_match_reference(reference):
    R = reference.requests
    assert (TRQ.BM_FALSE, TRQ.BM_TRUE, TRQ.BM_RECVD, TRQ.BM_BADSIG,
            TRQ.PROOF_TYPES) == (R.BM_FALSE, R.BM_TRUE, R.BM_RECVD,
                                 R.BM_BADSIG, R.PROOF_TYPES)
    for args in (("range", "s1", "dp0", "range-dp0", 0, b"\x01\x02"),
                 ("keyswitch", "survey-x", "cn2", "", 7, bytes(300))):
        assert TRQ._payload(*args) == R._payload(*args)


def test_transcripts_match_reference(reference, survey):
    vns, sid = survey.cluster.vns, survey.sq.survey_id
    assert TTR.survey_transcript(vns, sid) == \
        reference.transcript.survey_transcript(vns, sid)
    assert TTR.transcript_digest(vns, sid) == \
        reference.transcript.transcript_digest(vns, sid)
    assert len(TTR.survey_transcript(vns, sid).splitlines()) == 6 * N_VNS


# ---------------------------------------------------------------------------
# (b) stats encoders and decoders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", OPS_NO_PROOF + ["frequency_count_tiled"])
def test_stats_encode_decode_match_reference(reference, op):
    R = reference.stats
    rng = np.random.default_rng(hash(op) % 2 ** 31)
    qmin, qmax = (0, 15) if op != "frequency_count_tiled" else (0, 9000)
    op = op.replace("_tiled", "")
    per_dp = [rng.integers(qmin, min(qmax, 40) + 1, size=20)
              for _ in range(3)]
    per_dp[1][per_dp[1] == 0] = 1          # bool_AND: one DP all nonzero
    with _x64():
        ref = [np.asarray(R.encode_clear(op, d, qmin, qmax)) for d in per_dp]
    mine = [TST.encode_clear(op, d, qmin, qmax).numpy() for d in per_dp]
    for a, b in zip(mine, ref):
        assert a.dtype == np.int64 and np.array_equal(a, b)
    total = np.sum(mine, axis=0)
    found = np.ones(total.shape, bool)
    out = TST.decode(op, TST.DecryptedVector(total, found, total == 0),
                     qmin, qmax)
    want = R.decode(op, R.DecryptedVector(total, found, total == 0), qmin,
                    qmax)
    assert out == want


def test_stats_regression_ops_match_reference(reference):
    R = reference.stats
    rng = np.random.default_rng(9)
    X = rng.integers(-5, 6, size=(12, 3))
    preds = rng.integers(-5, 6, size=12)
    for op, data, kw in (("cosim", X[:, :2], {}), ("lin_reg", X, {}),
                         ("r2", X[:, 0], {"preds": preds})):
        with _x64():
            ref = np.asarray(R.encode_clear(op, data, **kw))
        assert np.array_equal(TST.encode_clear(op, data, **kw).numpy(), ref)
        dec = TST.DecryptedVector(ref, np.ones(ref.shape, bool), ref == 0)
        assert np.allclose(TST.decode(op, dec, dims=2), R.decode(
            op, R.DecryptedVector(ref, dec.found, dec.is_zero), dims=2))
    counts = np.array([0, 3, 0, 5, 2, 5])
    flags = (np.ones(6, bool), counts == 0)
    for mode in ("median", "quantile:0.9", "top_k:2"):
        assert TST.decode(mode, TST.DecryptedVector(counts, *flags)) \
            == R.decode(mode, R.DecryptedVector(counts, *flags))


# ---------------------------------------------------------------------------
# (c) canonical points, (d) aggregation and key-switch proofs
# ---------------------------------------------------------------------------

def _points(n, seed):
    """n points in Jacobian form with Z != 1 (sums), and infinity."""
    rng = np.random.default_rng(seed)
    a = TC.from_ref_batch([refimpl.g1_mul(refimpl.G1, int(k)) for k in
                           rng.integers(1, 1 << 40, size=n)])
    pts = TC.add(a, a.flip(0))
    pts[0] = TC.infinity(())
    return pts


def test_canon_points_bytes_match_reference(reference):
    pts = _points(9, 1).reshape(3, 3, 3, 16)
    with _x64(False):
        ref = np.asarray(reference.topology.canon_points(
            jnp.asarray(pts.numpy().astype(np.uint32))))
    mine = TTOP.canon_points(pts)
    assert mine.shape == pts.shape
    assert np.array_equal(mine.numpy().astype(np.uint32), ref)
    assert torch.equal(TTOP.canon_points(mine), mine)
    assert np.array_equal(mine.numpy()[0, 0], [
        params.to_limbs(params.R % params.P)] * 2 + [[0] * 16])


def test_aggregation_proof_bytes_match_reference(reference):
    cts = torch.stack([_points(6, s).reshape(3, 2, 3, 16) for s in (2, 3)])
    agg = TTOP.fold_cts(cts)
    mine = TAG.create_aggregation_proof(cts, agg)
    with _x64(False):
        ref = reference.aggregation.create_aggregation_proof(
            jnp.asarray(cts.numpy().astype(np.uint32)),
            jnp.asarray(agg.numpy().astype(np.uint32)))
        ref_bytes = ref.to_bytes()
    assert mine.to_bytes() == ref_bytes
    assert TAG.verify_aggregation_proof(mine).all()
    back = safe_loads(pickle.dumps(mine))
    assert back.to_bytes() == ref_bytes
    bad = TAG.create_aggregation_proof(cts, agg.flip(0))
    assert TAG.verify_aggregation_proof(bad).tolist() == [False, True, False]


def _global_pickle(module: str, name: str) -> bytes:
    """A protocol-4 pickle whose whole value is the global module.name
    (STACK_GLOBAL, nothing called): loading it must fail before the name
    resolves."""
    s = lambda t: b"\x8c" + bytes([len(t)]) + t.encode()
    return b"\x80\x04" + s(module) + s(name) + b"\x93."


@pytest.mark.parametrize("module,name", [
    ("drynx_tpu_torch.utils.cuda_build", "os.system"),
    ("drynx_tpu_torch.utils.cuda_build", "subprocess.run"),
    ("drynx_tpu_torch.proofs.safe_pickle", "torch.load"),
    ("drynx_tpu_torch.proofs.aggregation", "AggregationProofBatch.to"),
    ("torch", "load"),
    ("numpy", "load"),
    ("builtins", "eval"),
])
def test_hostile_pickles_are_refused(module, name):
    """A payload naming a callable, directly or through an allowed
    module's imports, never gets it."""
    assert pickle.loads(_global_pickle("builtins", "len")) is len
    with pytest.raises(pickle.UnpicklingError, match="forbidden global"):
        safe_loads(_global_pickle(module, name))


@pytest.fixture(scope="module")
def keyswitch(reference):
    """The reference's key-switch proof at ns=2, V=3, with its draws."""
    JE = reference.elgamal
    rng = np.random.default_rng(5)
    xs = [int(k) for k in rng.integers(1, 1 << 62, size=2)]
    q_pub = refimpl.g1_mul(refimpl.G1, 12345)
    orig_k = TC.from_ref_batch([refimpl.g1_mul(refimpl.G1, 7 + i)
                                for i in range(3)])
    key = jax.random.PRNGKey(3)
    with _x64(False):
        ks_rs = np.asarray(JE.random_scalars(jax.random.PRNGKey(9), (2, 3)))
        k1, k2 = jax.random.split(key)
        wr = np.asarray(JE.random_scalars(k1, (2, 3)))
        wx = np.asarray(JE.random_scalars(k2, (2, 3)))
    t = lambda a: torch.from_numpy(np.asarray(a).astype(np.int32))
    srv_x = torch.stack([TE.secret_to_limbs(x) for x in xs])
    q_tbl = TE.pub_table(q_pub).table
    # the contributions U = r B, W = r Q - x K, by the host oracle
    r = [[params.from_limbs(ks_rs[i, j]) for j in range(3)] for i in range(2)]
    ks = [refimpl.g1_mul(refimpl.G1, 7 + j) for j in range(3)]
    u = TC.from_ref_batch([refimpl.g1_mul(refimpl.G1, r[i][j])
                           for i in range(2) for j in range(3)])
    w = TC.from_ref_batch([refimpl.g1_add(
        refimpl.g1_mul(q_pub, r[i][j]),
        refimpl.g1_neg(refimpl.g1_mul(ks[j], xs[i])))
        for i in range(2) for j in range(3)])
    u, w = u.reshape(2, 3, 3, 16), w.reshape(2, 3, 3, 16)
    with _x64(False):
        J = lambda a: jnp.asarray(np.asarray(a).astype(np.uint32))
        ref = reference.keyswitch.create_keyswitch_proofs(
            key, J(orig_k), J(srv_x), J(ks_rs), J(TC.from_ref(q_pub)),
            J(q_tbl), J(u), J(w))
        ref_bytes = ref.to_bytes()
    return SimpleNamespace(ref=ref, ref_bytes=ref_bytes, orig_k=orig_k,
                           srv_x=srv_x, ks_rs=t(ks_rs), q_pub=q_pub,
                           q_tbl=q_tbl, u=u, w=w, draws=(t(wr), t(wx)), t=t)


def _port_batch(ref, t):
    return TKS.KeySwitchProofBatch(**{
        f.name: t(getattr(ref, f.name))
        for f in dataclasses.fields(TKS.KeySwitchProofBatch)})


@torch.inference_mode()
def test_keyswitch_proof_bytes_match_reference(keyswitch):
    k = keyswitch
    mine = TKS.create_keyswitch_proofs(
        k.orig_k, k.srv_x, k.ks_rs, TC.from_ref(k.q_pub), k.q_tbl, k.u, k.w,
        draws=k.draws)
    assert mine.to_bytes() == k.ref_bytes
    assert safe_loads(pickle.dumps(mine)).to_bytes() == k.ref_bytes


@torch.inference_mode()
def test_keyswitch_verifiers_agree_with_reference(reference, keyswitch):
    """The port's verifier on the reference's proof and on a copy with one
    zx limb changed, in one batch (the rows of the second are servers 2
    and 3), and the reference's verifier on the changed copy."""
    k = keyswitch
    ref_proof = _port_batch(k.ref, k.t)
    zx = ref_proof.zx.clone()
    zx[1, 2, 0] ^= 1
    both = dataclasses.replace(ref_proof, **{
        f: torch.cat([getattr(ref_proof, f), getattr(ref_proof, f)])
        for f in ("u_pts", "w_pts", "ys", "a1", "a2", "a3", "challenge",
                  "zr")}, zx=torch.cat([ref_proof.zx, zx]))
    want = np.ones((4, 3), bool)
    want[3, 2] = False
    assert np.array_equal(TKS.verify_keyswitch_proofs(both, k.q_tbl), want)
    with _x64(False):
        ref_bad = dataclasses.replace(
            k.ref, zx=jnp.asarray(zx.numpy().astype(np.uint32)))
        got = np.asarray(reference.keyswitch.verify_keyswitch_proofs(
            ref_bad, jnp.asarray(k.q_tbl.numpy().astype(np.uint32))))
    assert np.array_equal(got, want[2:])


# ---------------------------------------------------------------------------
# (e) Schnorr envelopes across the packages
# ---------------------------------------------------------------------------

def test_schnorr_signatures_verify_across_packages(reference):
    R = reference.schnorr
    x = 0xC0FFEE1234567
    pub = refimpl.g1_mul(refimpl.G1, x)
    msg = TRQ._payload("aggregation", "s", "cn0", "", 0, b"body")
    mine = TSCH.sign(x, msg)
    theirs = R.sign(x, msg)
    assert R.verify(pub, msg, R.Signature.from_bytes(mine.to_bytes()))
    assert TSCH.verify(pub, msg, TSCH.Signature.from_bytes(theirs.to_bytes()))
    assert not TSCH.verify(pub, msg + b"!", mine)
    assert TSCH.sign(x, msg, k=77).to_bytes() == R.sign(x, msg,
                                                        k=77).to_bytes()


# ---------------------------------------------------------------------------
# (f) the cluster
# ---------------------------------------------------------------------------

def test_cluster_keys_match_reference(reference):
    mine = TSV.LocalCluster(n_cns=3, n_dps=4, n_vns=2, seed=SEED,
                            dlog_limit=20, device="cpu")
    ref = reference.service.LocalCluster(n_cns=3, n_dps=4, n_vns=2,
                                         seed=SEED, dlog_limit=20,
                                         precompile="off")
    ident = lambda c: [(n.name, n.secret, n.public) for n in
                       c.cns + c.dp_idents + c.vn_idents + [c.client]]
    assert ident(mine) == ident(ref)
    assert mine.coll_pub == ref.coll_pub
    assert np.array_equal(mine.coll_tbl.table.numpy(),
                          np.asarray(ref.coll_tbl.table).astype(np.int32))
    assert np.array_equal(mine.client_tbl.table.numpy(),
                          np.asarray(ref.client_tbl.table).astype(np.int32))
    assert mine.server_to_dp == ref.server_to_dp
    assert mine.rng.bytes(8) == ref.rng.bytes(8)


def test_proofs_on_survey_decrypts_and_commits_a_clean_block(survey):
    res, sq = survey.res, survey.sq
    allv = np.concatenate(survey.data)
    assert res.decrypted.found.all()
    assert res.decrypted.values.tolist() == [int(allv.sum()), len(allv)]
    assert res.result == pytest.approx(float(allv.mean()))
    assert res.block is not None and res.block.data.survey_id == sq.survey_id
    bitmap = res.block.data.bitmap
    assert len(bitmap) == 6 * N_VNS and set(bitmap.values()) == {TRQ.BM_TRUE}
    assert sorted({k.split("/")[1] for k in bitmap}) == [
        "aggregation", "keyswitch", "range"]
    assert survey.cluster.vns.root.chain.validate()
    for vn in survey.cluster.vns.vns:
        assert sorted(vn.stored_proofs(sq.survey_id)) == sorted(
            k.split(":", 1)[1] for k in bitmap if k.startswith(vn.name))
    for name in ("DataCollectionProtocol", "AggregationPhase",
                 "KeySwitchingPhase", "Decryption", "VerifyRange",
                 "VerifyAggregation", "VerifyKeySwitch", "AllProofs"):
        assert res.timers[name] > 0, name


def test_proofs_on_survey_launches_match_chip_smoke(survey):
    """The wrapper calls of one proofs-on survey are chip_smoke.py's
    phase-7 constant, but for two differences of that log_reg survey: no
    signed-offset correction here, and the range check's two folds take
    two passes each over 2 x 2 x 2 x 3 = 24 digit proofs (8^2), five over
    13,500 (8^5)."""
    cs = _chip_smoke()
    want = {k: v - cs.SIGNED_OFFSET_LAUNCHES.get(k, 0)
            for k, v in cs.EXPECTED_LAUNCHES_CLUSTER.items()}
    want["f12_mulreduce8"] -= 2 * (5 - 2)
    assert survey.counts == want


def test_registry_names_every_launch_of_the_survey(survey):
    """Each kernel the survey launched names an entry of the warm-up
    registry for its shape (the admission's profile), and the registry
    names no kernel the survey does not launch; every call's rows were
    read by `cuda_build.launch_rows`."""
    names = {e.name for e in cc.build_registry(survey.profile)
             if e.kind == "kernel"}
    got = {f"kernel:{k}" for k, _ in survey.rows}
    assert sum(survey.rows.values()) == sum(survey.counts.values())
    assert got == names, sorted(got ^ names)


def test_warm_up_builds_the_tables_and_the_survey_none(survey):
    """On the CPU the warm-up builds the signature tables of base u on the
    calling thread and skips every kernel and library entry; the survey
    after it builds no table."""
    rows = survey.warm.rows
    assert rows[f"table:range_sigs@u{U}"]["status"] == "executed"
    assert rows["table:gt_base"]["status"] == "executed"
    assert all(r["status"] == "skipped" for n, r in rows.items()
               if not n.startswith("table:"))
    assert survey.warm.count("error") == 0
    assert ("table", "sig_gt_pow_tables", "MainThread") in \
        survey.warm_events
    assert {t for _, _, t in survey.warm_events} == {"MainThread"}
    assert survey.survey_events == []
    assert survey.sig_builds[0] == survey.sig_builds[1]
    assert sum(survey.warm.launches.values()) == 0


def test_tampered_aggregation_payload_is_recorded_false(survey):
    cluster, sid = survey.cluster, survey.sq.survey_id
    vn = cluster.vns.vns[1]
    key = f"{sid}/aggregation/cn0/aggregation-cn0"
    proof = safe_loads(vn.stored_proofs(sid)[key])
    proof.aggregate = proof.aggregate.flip(0)
    cn = cluster.cns[0]
    req = TRQ.new_proof_request("aggregation", sid, cn.name,
                                "aggregation-cn0", 0, pickle.dumps(proof),
                                cn.secret)
    assert vn.receive_proof(req) == TRQ.BM_FALSE
    assert vn.bitmap_for(sid)[key] == TRQ.BM_FALSE
    assert cluster.vns.vns[0].bitmap_for(sid)[key] == TRQ.BM_TRUE


@pytest.mark.parametrize("exc", [
    KernelError("CUDA launch of f12_mul failed: cudaError 98"),
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    torch.cuda.OutOfMemoryError("out of memory"),
    ValueError("a malformed payload")], ids=["kernel", "cuda", "oom",
                                              "payload"])
def test_kernel_faults_propagate_out_of_the_vns(survey, exc):
    cluster, sid = survey.cluster, survey.sq.survey_id
    vn = cluster.vns.vns[0]
    key = f"{sid}/keyswitch/cn1/keyswitch-cn1"
    data = vn.stored_proofs(sid)[key] + type(exc).__name__.encode()
    cn = cluster.cns[1]
    req = TRQ.new_proof_request("keyswitch", sid, cn.name, "keyswitch-cn1",
                                0, data, cn.secret)

    def raising(_data, _sid):
        raise exc

    saved = vn.verify_fns["keyswitch"]
    vn.verify_fns["keyswitch"] = raising
    try:
        if isinstance(exc, ValueError):
            assert vn.receive_proof(req) == TRQ.BM_FALSE
        else:
            with pytest.raises(type(exc)):
                vn.receive_proof(req)
            assert vn.bitmap_for(sid)[key] == TRQ.BM_TRUE
    finally:
        vn.verify_fns["keyswitch"] = saved


def test_step16_options_run_and_match_the_reference(reference, survey,
                                                    tmp_path):
    """Responder sets, both quorums, the liveness probe and the checkpoint
    store (step 16) are accepted: a responder set below the quorum and a
    quorum above the responders raise the reference's RuntimeError and
    leave its checkpoint, the probe maps the DPs as the reference's does,
    a VN quorum commits the survey's block, and the checkpoints persist.
    DRO noise, group-by and cutting factors are accepted too, with the
    shuffle proofs counted and thresholded and the output sized by groups
    and replicas. Grouped, cut and held surveys run in
    tests/test_torch_groupby.py and tests/test_torch_held_range.py; the
    degraded surveys in tests/test_torch_quorum.py."""
    from drynx_tpu.resilience import faults as JF
    from drynx_tpu_torch.resilience import faults as TF

    cluster = survey.cluster
    diffp = TQ.DiffPParams(noise_list_size=4, lap_scale=2.0, quanta=1.0,
                           scale=1.0, limit=8.0)
    sq = cluster.generate_survey_query("sum", query_min=0, query_max=15,
                                       proofs=1, diffp=diffp,
                                       thresholds=0.5)
    assert sq.threshold == 0.5
    assert TQ.query_to_proofs_nbrs(sq)[1] == N_CNS
    grouped = cluster.generate_survey_query("sum", group_by=[[0, 1]])
    assert grouped.query.n_groups() == 2
    cut = cluster.generate_survey_query("mean", cutting_factor=2)
    assert cut.query.operation.nbr_output == 4
    quorum = cluster.generate_survey_query("mean", query_min=0,
                                           query_max=15, min_dp_quorum=1,
                                           vn_quorum=0.5)
    assert (quorum.min_dp_quorum, quorum.vn_quorum) == (1, 0.5)

    ref = reference.service.LocalCluster(n_cns=N_CNS, n_dps=N_DPS, n_vns=0,
                                         seed=SEED, dlog_limit=2)
    cluster.attach_checkpoint_store(str(tmp_path / "ckpt.db"))
    out = []
    try:
        for cl, faults in ((ref, JF), (cluster, TF)):
            rows = []
            for sid, kw, responders in (
                    ("step16-resp", {}, ["dp0"]),
                    ("step16-quorum", {"min_dp_quorum": N_DPS + 1}, None)):
                with pytest.raises(RuntimeError) as ei:
                    cl.execute_survey(dataclasses.replace(
                        survey.sq, survey_id=sid, **kw),
                        responders=responders)
                rows.append((str(ei.value),
                             dataclasses.asdict(cl.checkpoint_for(sid))))
            alive = [cl.probe_liveness()]
            plan = faults.FaultPlan(seed=0)
            plan.kill("dp1")
            faults.set_fault_plan(plan)
            alive.append(cl.probe_liveness())
            faults.set_fault_plan(None)
            out.append((rows, alive))
    finally:
        JF.set_fault_plan(None)
        TF.set_fault_plan(None)
    assert out[1] == out[0]
    assert out[1][1] == [{"dp0": True, "dp1": True},
                         {"dp0": True, "dp1": False}]
    assert "only 1/2 DPs responded (quorum 2)" in out[1][0][0][0]
    # the finished survey's block again, from a VN quorum of one half:
    # every VN is done, so every VN's entries (earlier tests of this
    # module recorded some tampered envelopes since)
    sid = survey.sq.survey_id
    block = cluster.vns.end_verification(sid, timeout=5.0, quorum=0.5)
    assert set(block.data.bitmap) == set(survey.res.block.data.bitmap)
    assert block.data.bitmap == {
        f"{vn.name}:{k}": v for vn in cluster.vns.vns
        for k, v in vn.bitmap_for(sid).items()}
    assert survey.res.responders == [f"dp{i}" for i in range(N_DPS)]
    assert (survey.res.absent, survey.res.resumes) == ([], 0)
    assert set(survey.res.phases.values()) == {1}
    stored = TSTORE.SurveyCheckpoint.load(
        TSTORE.ProofDB(str(tmp_path / "ckpt.db")), "step16-resp")
    assert dataclasses.asdict(stored) == out[1][0][0][1]


def test_close_removes_the_vn_stores():
    cluster = TSV.LocalCluster(n_cns=1, n_dps=1, n_vns=1, seed=SEED,
                               dlog_limit=2, device="cpu")
    db = Path(cluster.vns.root.db.path)
    cluster.vns.root.db.put("k", b"v")
    assert db.is_file()
    cluster.close()
    assert not db.parent.exists()


# ---------------------------------------------------------------------------
# (g) proofs off: log_reg against the reference's gradient descent
# ---------------------------------------------------------------------------

def test_proofs_off_log_reg_matches_reference_gd(reference):
    X, y, p = TFL.pima_shaped_problem(num_dps=2, n_records=16, d=2,
                                      max_iterations=10)
    client = DrynxClient(n_cns=2, n_dps=2, n_vns=0, seed=SEED,
                         dlog_limit=400, device="cpu")
    clear = []
    for i, dp in enumerate(client.cluster.dps.values()):
        dp.data = TLR.shard_for_dp(X, y, i, 2)
        clear.append(TLR.encode_clear(*dp.data, p).numpy())
    sq = client.generate_survey_query("log_reg", lr_params=p)
    res = client.send_survey_query(sq, seed=SEED)
    assert res.block is None and res.decrypted.found.all()
    assert np.array_equal(res.decrypted.values, np.sum(clear, axis=0))
    R = reference.logreg
    rp_ = R.LRParams(**dataclasses.asdict(p))
    with _x64():
        want = np.asarray(R.train(R.unpack(jnp.asarray(res.decrypted.values),
                                           rp_), rp_))
    assert res.result.shape == (3,) and np.isfinite(res.result).all()
    np.testing.assert_allclose(res.result, want, rtol=1e-3, atol=1e-3)
