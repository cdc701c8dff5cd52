"""The streaming engine of the PyTorch port, on the CPU, against the JAX
reference.

* The pane fold: given the reference's pane ciphertexts (real curve
  points, reference tests/test_streaming.py:190-240), the port's
  `slide_window` (ct_sub of the expired panes, ct_add of the new ones,
  canon_points) gives the reference's from-scratch window bytes at 1-, 2-
  and 4-pane slides, at multi-pane expiry and after subtracting to empty.
* A port engine restarted on the same rows reproduces its own bytes: the
  survey id, the window ciphertext (a delta advance equal to a
  from-scratch fold), the decrypted values; an engine on another stream
  id with the same seed seals the same pane ciphertexts.
* A DiffP stream takes its DRO precomputation from the cluster's crypto
  pool; its answer is the clear counts plus the final noise list's values
  at index v % S.
* Epsilon charged at advance admits exactly the budget, then refuses
  before the window moves; the encodings outside ADDITIVE_OPS are
  refused; the stream constants and pane keys are the reference's.
* Slow: the proofs-on stream (pane proofs delivered once under stable
  pane ids, the ProofDB reuse across a restart, equal transcripts).
"""
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drynx_tpu.crypto import elgamal as JE
from drynx_tpu.crypto import refimpl
from drynx_tpu.resilience import policy as JPOL
from drynx_tpu.service import store as JSTORE
from drynx_tpu.service import topology as JTOPO
from drynx_tpu_torch import pool as pool_mod
from drynx_tpu_torch.crypto import params
from drynx_tpu_torch.crypto.curve import to_ref
from drynx_tpu_torch.parallel import dro
from drynx_tpu_torch.pool import replenish
from drynx_tpu_torch.proofs import requests as rq
from drynx_tpu_torch.resilience import policy as pol
from drynx_tpu_torch.server.transcript import transcript_digest
from drynx_tpu_torch.service import store, streaming
from drynx_tpu_torch.service import topology as topo
from drynx_tpu_torch.service.query import DiffPParams
from drynx_tpu_torch.service.service import LocalCluster
from drynx_tpu_torch.service.streaming import StreamEngine
from test_torch_range_proof import reference  # noqa: F401  (a fixture)


def test_stream_constants_and_pane_keys_are_the_references():
    for name in ("PANE_WIDTH", "STREAM_WINDOW_PANES", "EPSILON_BUDGET",
                 "EPSILON_PER_ADVANCE", "SLIDE_PACING_S"):
        assert getattr(pol, name) == getattr(JPOL, name), name
    assert store.pane_key("s-1", 7, "dp0") == JSTORE.pane_key("s-1", 7, "dp0")
    assert streaming.ADDITIVE_OPS == ("frequency_count", "sum")


# ---------------------------------------------------------------------------
# The pane fold against the reference's bytes
# ---------------------------------------------------------------------------

def _ref_ct_stack(k: int, v: int, seed: int) -> np.ndarray:
    """(k, V, 2, 3, 16) uint32 pane folds of the reference: fixed-base
    multiples of G1 (reference tests/test_streaming.py's helper; the
    reference's fixed-base product needs the `reference` fixture's
    stand-in on this jax)."""
    rng = np.random.default_rng(seed)
    scalars = rng.integers(1, 2 ** 31, size=(k * v * 2,))
    limbs = np.stack([JE.secret_to_limbs(int(s)) for s in scalars])
    pts = np.asarray(JE.fixed_base_mul(JE.BASE_TABLE.table, limbs))
    return pts.reshape(k, v, 2, 3, 16).astype(np.uint32)


def _ref_fold(stack: np.ndarray) -> bytes:
    return np.asarray(JTOPO.fold_cts(jnp.asarray(stack))).tobytes()


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.int32))


def _bytes(t: torch.Tensor) -> bytes:
    return t.numpy().astype(np.uint32).tobytes()


def test_slides_equal_the_references_window_bytes(reference):
    """A window of 4 panes moved by 1, 2 and 4 panes (the last expires the
    whole window): each delta equals the reference's fold of the new
    window."""
    stack = _ref_ct_stack(k=11, v=2, seed=13)
    first, last = 0, 3
    cur = topo.fold_cts(_t(stack[first:last + 1]))
    assert _bytes(cur) == _ref_fold(stack[first:last + 1])
    for slide in (1, 2, 4):
        nf, nl = first + slide, last + slide
        expired = range(first, min(nf, last + 1))
        added = range(max(last + 1, nf), nl + 1)
        cur = streaming.slide_window(cur, [_t(stack[i]) for i in expired],
                                     [_t(stack[i]) for i in added])
        assert _bytes(cur) == _ref_fold(stack[nf:nl + 1]), slide
        first, last = nf, nl


def test_subtract_to_empty_then_rebuild_equals_the_reference(reference):
    stack = _ref_ct_stack(k=3, v=2, seed=31)
    empty = streaming.slide_window(topo.fold_cts(_t(stack)),
                                   [_t(p) for p in stack], [])
    ref_empty = JTOPO.canon_points(JE.ct_sub(
        jnp.asarray(np.asarray(JTOPO.fold_cts(jnp.asarray(stack)))),
        jnp.asarray(np.asarray(JTOPO.fold_cts(jnp.asarray(stack))))))
    assert _bytes(empty) == np.asarray(ref_empty).tobytes()
    rebuilt = streaming.slide_window(empty, [], [_t(stack[1])])
    lone = np.asarray(JTOPO.canon_points(jnp.asarray(stack[1]))).tobytes()
    assert _bytes(rebuilt) == lone


# ---------------------------------------------------------------------------
# The port's engine, proofs off
# ---------------------------------------------------------------------------

PW, V = 6, 8
DIFFP = DiffPParams(noise_list_size=6, lap_mean=0.0, lap_scale=2.0,
                    quanta=1.0, scale=1.0, limit=8.0)


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    """One CN, so an advance's key switch and decryption are one ladder
    each; one torch thread runs the plain versions faster here. Its crypto
    pool serves the DiffP stream's DRO."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    slabs = pool_mod.CryptoPool(str(tmp_path_factory.mktemp("pool")),
                                slab_elems=DIFFP.noise_list_size)
    c = LocalCluster(n_cns=1, n_dps=2, n_vns=0, seed=7, dlog_limit=100,
                     pool=slabs, device="cpu")
    yield c
    c.close()
    torch.set_num_threads(n)


def _engine(cluster, stream_id, **kw):
    return StreamEngine(cluster, "frequency_count", 0, V - 1,
                        stream_id=stream_id, pane_width=PW, window_panes=2,
                        proofs=0, seed=9, **kw)


def test_restarted_engine_reproduces_its_bytes(cluster, tmp_path):
    """e1 advances over a window of the last 2 of 3 panes under a ledger of
    exactly one advance; a restarted engine on the same stream id, fed the
    same rows, reproduces the survey id, the pane and window bytes and the
    decrypted values; an engine on another stream id with the same seed
    seals the same pane ciphertexts; e1's second advance is refused before
    its window moves. (The delta path is held against the reference's
    bytes above, and through the engine in the slow test.)"""
    rng = np.random.default_rng(0)
    rows = {d.name: rng.integers(0, V, size=(4, PW))
            for d in cluster.dp_idents}
    led = pool_mod.EpsilonLedger(str(tmp_path), budget=0.01)
    e1 = _engine(cluster, "s", epsilon_ledger=led, epsilon_per_advance=0.01)
    e1.feed({n: r[:3].reshape(-1) for n, r in rows.items()})
    a1 = e1.advance()
    assert (a1.window, a1.panes_new, a1.panes_expired) == ((1, 2), 2, 0)
    assert a1.survey_id == "s-w1-2"
    truth = Counter()
    for r in rows.values():
        truth.update(r[1:3].reshape(-1).tolist())
    assert a1.result == {v: truth.get(v, 0) for v in range(V)}
    assert _bytes(e1.window_ct) == _bytes(topo.fold_cts(torch.stack(
        [e1._panes[1].fold, e1._panes[2].fold])))

    e2 = _engine(cluster, "s")
    e2.feed({n: r[:3].reshape(-1) for n, r in rows.items()})
    a2 = e2.advance()
    assert a2.survey_id == a1.survey_id and a2.result == a1.result
    assert _bytes(e2.window_ct) == _bytes(e1.window_ct)
    assert a2.decrypted.values.tobytes() == a1.decrypted.values.tobytes()
    assert all(_bytes(p.fold) == _bytes(q.fold)
               for p, q in zip(e1._panes, e2._panes))

    # the same seed on another stream id seals the same pane ciphertexts
    e3 = _engine(cluster, "other")
    e3.feed({n: r[0] for n, r in rows.items()})
    assert _bytes(e3._seal_next_pane().fold) == _bytes(e1._panes[0].fold)

    # one advance spent the budget exactly: the next is refused
    assert led.spent(cluster.dp_idents[0].name, e1.cohort) == \
        pytest.approx(0.01)
    e1.feed({n: r[3] for n, r in rows.items()})
    with pytest.raises(pool_mod.EpsilonExhausted):
        e1.advance()
    assert e1.counters["advances"] == 1
    assert (e1._win_first, e1._win_last) == (1, 2)
    assert led.counters["rejections"] == 1


def test_non_additive_ops_and_bad_shapes_are_refused(cluster):
    with pytest.raises(ValueError, match="additive"):
        StreamEngine(cluster, "mean", 0, 9, proofs=0)
    with pytest.raises(ValueError, match="positive"):
        StreamEngine(cluster, "sum", 0, 9, proofs=0, pane_width=-1)
    e = StreamEngine(cluster, "sum", 0, 9, proofs=0, pane_width=4)
    assert (e.pane_width, e.window_panes) == (4, pol.STREAM_WINDOW_PANES)
    with pytest.raises(ValueError, match="no sealed panes"):
        e.advance()
    with pytest.raises(KeyError):
        e.feed({"nobody": [1]})
    e.feed({d.name: [1, 2, 3] for d in cluster.dp_idents})
    assert e.sealable_panes() == 0


@torch.inference_mode()
def test_diffp_stream_takes_its_dro_from_the_pool(cluster, monkeypatch):
    """A proofs-off DiffP stream on a cluster whose crypto pool holds one
    slab (`replenish.refill_to`): the advance's DRO takes it and computes
    nothing fresh. The answer is the window's clear counts plus the final
    noise list's value at index v % S, and that list decrypts to a
    permutation of the clear noise list."""
    S, slabs = DIFFP.noise_list_size, cluster.pool
    final, shuffle = {}, dro.shuffle_rerandomize

    def recorded(*a, **k):
        out = shuffle(*a, **k)
        final["out"] = out[0]
        return out

    monkeypatch.setattr(dro, "shuffle_rerandomize", recorded)
    assert replenish.refill_to(slabs, torch.Generator().manual_seed(1),
                               cluster.coll_tbl.table, S) == 1
    e = _engine(cluster, "dp", diffp=DIFFP)
    rows = {d.name: np.random.default_rng(5).integers(0, V, size=PW)
            for d in cluster.dp_idents}
    e.feed(rows)
    calls, consumed = dro.PRECOMPUTE_CALLS, slabs.stats()["consumed"]
    adv = e.advance()
    assert dro.PRECOMPUTE_CALLS == calls
    assert slabs.stats()["consumed"] == consumed + 1
    assert slabs.stats()["slabs_live"] == 0
    # the final list, decrypted on the host: m B = C2 - x C1, |m| <= 8
    x = sum(cn.secret for cn in cluster.cns) % params.N
    small = {refimpl.g1_mul(refimpl.G1, m % params.N): m
             for m in range(-8, 9)}
    pts = to_ref(final["out"].reshape(-1, 3, 16))
    noise = [small[refimpl.g1_add(c2, refimpl.g1_neg(refimpl.g1_mul(c1, x)))]
             for c1, c2 in zip(pts[0::2], pts[1::2])]
    assert sorted(noise) == sorted(dro.generate_noise_values(
        S, DIFFP.lap_mean, DIFFP.lap_scale, DIFFP.quanta, DIFFP.scale,
        DIFFP.limit).tolist())
    truth = Counter()
    for r in rows.values():
        truth.update(r.tolist())
    assert adv.decrypted.found.all()
    assert adv.decrypted.values.tolist() == [
        truth.get(v, 0) + noise[v % S] for v in range(V)]


def test_pane_seeds_are_pure():
    assert streaming.pane_seed(9, 1, 0) == streaming.pane_seed(9, 1, 0)
    seeds = {streaming.pane_seed(9, k, p) for k in (1, 2) for p in range(4)}
    assert len(seeds) == 8 and all(0 <= s < 2 ** 63 for s in seeds)


# ---------------------------------------------------------------------------
# The proofs-on stream (slow)
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_proofs_on_stream_delivers_panes_once_and_restarts(tmp_path):
    """2 CNs, 2 DPs, 2 VNs: every pane's proofs delivered and committed
    once at seal, an advance ships only the CNs' aggregation proofs, a
    from-scratch engine on the same id gives equal results, bytes and
    transcripts with no fresh pane verification, and a restarted engine
    with the ProofDB reuses every blob."""
    c = LocalCluster(n_cns=2, n_dps=2, n_vns=2, seed=1, dlog_limit=4000,
                     device="cpu")
    try:
        rng = np.random.default_rng(0)
        rows = {d.name: rng.integers(0, 4, size=(4, 4))
                for d in c.dp_idents}
        db = store.ProofDB(str(tmp_path / "panes.db"))

        def mk(sid, db=None):
            return StreamEngine(c, "frequency_count", 0, 3, stream_id=sid,
                                pane_width=4, window_panes=2,
                                ranges=[(4, 2)] * 4, proofs=1, seed=9,
                                pane_db=db)

        e = mk("p", db)
        sealed = 0
        for slide in (2, 1, 1):
            e.feed({n: r[sealed:sealed + slide].reshape(-1)
                    for n, r in rows.items()})
            adv = e.advance()
            sealed += slide
            assert set(adv.block.data.bitmap.values()) == {rq.BM_TRUE}
            assert len(adv.block.data.bitmap) == 2 * 2   # VNs x CNs
        assert all(set(p.block.data.bitmap.values()) == {rq.BM_TRUE}
                   for p in e._panes)
        assert e.counters["proofs_created"] == 4 * 2
        dig = transcript_digest(c.vns, adv.survey_id)
        pane_digs = [transcript_digest(c.vns, e.pane_sid(p))
                     for p in range(4)]

        again = mk("p", store.ProofDB(str(tmp_path / "panes.db")))
        again.feed({n: r.reshape(-1) for n, r in rows.items()})
        a2 = again.advance()
        assert again.counters["proofs_created"] == 0
        assert again.counters["proofs_reused"] == 4 * 2
        assert again.counters["pane_verifies"] == 0
        assert a2.survey_id == adv.survey_id and a2.result == adv.result
        assert _bytes(again.window_ct) == _bytes(e.window_ct)
        assert transcript_digest(c.vns, a2.survey_id) == dig
        assert [transcript_digest(c.vns, again.pane_sid(p))
                for p in range(4)] == pane_digs
    finally:
        c.close()
