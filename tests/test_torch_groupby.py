"""Group-by and cutting factors in the PyTorch port, on the CPU, against the
JAX reference.

The grouped encoders of the 12 encoder ops of tests/test_groupby.py, the
group grid, the grid width and the grouped decoder (its decode modes and
the empty-group table) equal the reference's functions exactly. A
proofs-off grouped survey (3 CNs, 3 DPs, 6 groups, 20 rows a DP) decodes
every group's clear result; a proofs-off survey at cutting factor 2
decrypts two equal replicas and the cutting factor 1 answer; the query
refusals raise the reference's ValueError. The proofs-on grouped survey is
`slow`.
"""
import numpy as np
import pytest
import torch

from drynx_tpu.encoding import stats as JST
from drynx_tpu.service.query import (Operation as JOperation,
                                     Query as JQuery)
from drynx_tpu_torch.encoding import stats as st
from drynx_tpu_torch.models import logreg as lr
from drynx_tpu_torch.proofs import requests as rq
from drynx_tpu_torch.service.query import Operation, Query
from drynx_tpu_torch.service.service import LocalCluster

GROUP_BY = [[0, 1], [10, 20, 30]]  # 2 attributes -> 6 groups
ENCODER_OPS = ["sum", "mean", "variance", "min", "max", "frequency_count",
               "union", "inter", "bool_OR", "bool_AND", "cosim", "lin_reg"]


def _rand_groups(rows, rng, group_by=GROUP_BY):
    return np.stack([rng.choice(np.asarray(vals), size=rows)
                     for vals in group_by], axis=-1).astype(np.int64)


def _data(op, rows, qmin, qmax, rng):
    if op == "cosim":
        return rng.integers(0, 9, size=(rows, 2)).astype(np.int64)
    if op == "lin_reg":
        X = rng.integers(0, 5, size=(rows, 2)).astype(np.int64)
        return np.concatenate([X, (X[:, 0] + 2 * X[:, 1])[:, None]], axis=1)
    return rng.integers(qmin, qmax + 1, size=(rows,)).astype(np.int64)


# ---------------------------------------------------------------------------
# Encoders and decoders against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", ENCODER_OPS)
def test_grouped_encoder_equals_the_reference(op):
    """Every op, with a group left empty on purpose (its sentinels and
    identities), and the bit-scaled OR/AND family."""
    rows, qmin, qmax = 40, 0, 12
    rng = np.random.default_rng(ENCODER_OPS.index(op) + 91)
    data = _data(op, rows, qmin, qmax, rng)
    groups = _rand_groups(rows, rng)
    groups[groups[:, 1] == 30, 0] = 0      # group (1, 30) stays empty
    grid = st.group_grid(GROUP_BY)
    want = np.asarray(JST.encode_clear_grouped(op, data, groups, grid,
                                               qmin, qmax))
    got = st.encode_clear_grouped(op, data, groups, grid, qmin, qmax)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    if op in ("bool_OR", "bool_AND", "min", "max", "union", "inter"):
        want = np.asarray(JST.encode_clear_grouped(
            op, data, groups, grid, qmin, qmax, bit_scale=7))
        got = st.encode_clear_grouped(op, data, groups, grid, qmin, qmax,
                                      bit_scale=7)
        np.testing.assert_array_equal(got.numpy(), want)


def test_grouped_r2_equals_the_reference():
    rng = np.random.default_rng(5)
    y = rng.integers(0, 9, size=30)
    preds = rng.integers(0, 9, size=30)
    groups = _rand_groups(30, rng)
    grid = st.group_grid(GROUP_BY)
    np.testing.assert_array_equal(
        st.encode_clear_grouped("r2", y, groups, grid, preds=preds).numpy(),
        np.asarray(JST.encode_clear_grouped("r2", y, groups, grid,
                                            preds=preds)))
    with pytest.raises(ValueError, match="grouped"):
        st.encode_clear_grouped("nope", y, groups, grid)


def test_group_grid_and_grid_buckets_equal_the_reference():
    for gb in (GROUP_BY, [[5]], [[3, 1], [2], [7, 8, 9]]):
        got, want = st.group_grid(gb), JST.group_grid(gb)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert st.group_grid(GROUP_BY).shape == (6, 2)
    for name, qmin, qmax in (("frequency_count", 3, 17), ("max", 0, 999),
                             ("sum", 0, 9), ("log_reg", 0, 0)):
        q, jq = (Query(operation=Operation(name, 1, 1, qmin, qmax)),
                 JQuery(operation=JOperation(name, 1, 1, qmin, qmax)))
        assert st.grid_buckets(q) == JST.grid_buckets(jq)
    assert st.grid_buckets(object()) == JST.grid_buckets(object()) == 0


DECODE_CASES = [
    # op, per-group values (2 groups), qmin, qmax
    ("sum", [[5], [0]], 0, 9),
    ("mean", [[6, 3], [0, 0]], 0, 9),
    ("variance", [[14, 3, 70], [0, 0, 0]], 0, 9),
    ("cosim", [[3, 4, 5, 6, 5], [0, 0, 0, 0, 0]], 0, 9),
    ("bool_OR", [[0], [3]], 0, 1),
    ("bool_AND", [[0], [2]], 0, 1),
    ("min", [[0, 0, 2, 2], [0, 0, 0, 0]], 0, 3),
    ("max", [[2, 2, 0, 0], [0, 0, 0, 0]], 0, 3),
    ("frequency_count", [[1, 0, 2], [0, 0, 0]], 0, 2),
    ("union", [[0, 1, 0], [0, 0, 0]], 0, 2),
    ("inter", [[0, 1, 0], [1, 1, 1]], 0, 2),
    ("median", [[2, 0, 1], [0, 0, 0]], 0, 2),
    ("quantile:0.9", [[2, 0, 1], [0, 0, 0]], 0, 2),
    ("top_k:2", [[2, 0, 1], [0, 0, 0]], 0, 2),
    ("r2", [[3, 6, 14, 1], [0, 0, 0, 0]], 0, 9),
    ("lin_reg", [[3, 3, 5, 6, 11, 13], [0, 0, 0, 0, 0, 0]], 0, 9),
]


@pytest.mark.parametrize("op,vals,qmin,qmax", DECODE_CASES,
                         ids=[c[0] for c in DECODE_CASES])
def test_decode_grouped_equals_the_reference(op, vals, qmin, qmax):
    """Each decode mode, with the second group empty: None where the op
    can say so, query_min for max (the reference's ambiguity table)."""
    v = np.asarray(vals, dtype=np.int64).reshape(-1)
    grid = np.asarray([[0], [1]])
    got = st.decode_grouped(op, st.DecryptedVector(
        values=v, found=np.ones_like(v, bool), is_zero=v == 0), grid,
        qmin, qmax)
    want = JST.decode_grouped(op, JST.DecryptedVector(
        values=v, found=np.ones_like(v, bool), is_zero=v == 0), grid,
        qmin, qmax)
    assert list(got) == list(want) == [(0,), (1,)]
    for g in want:
        if isinstance(want[g], np.ndarray):
            np.testing.assert_array_equal(got[g], want[g])
        else:
            assert got[g] == want[g], (g, got[g], want[g])
    if op in ("mean", "variance", "cosim", "min", "median", "r2"):
        assert got[(1,)] is None
    if op == "max":
        assert got[(1,)] == qmin


# ---------------------------------------------------------------------------
# Grouped and cut surveys through LocalCluster (proofs off)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cluster():
    """The plain versions are many small tensor ops: one torch thread runs
    them faster here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    c = LocalCluster(n_cns=3, n_dps=3, n_vns=0, seed=7, dlog_limit=5000,
                     device="cpu")
    yield c
    c.close()
    torch.set_num_threads(n)


def _feed_groups(cluster, rows, qmin, qmax, seed):
    rng = np.random.default_rng(seed)
    all_data, all_groups = [], []
    for dp in cluster.dps.values():
        dp.data = rng.integers(qmin, qmax + 1, size=(rows,)).astype(np.int64)
        dp.groups = _rand_groups(rows, rng)
        all_data.append(dp.data)
        all_groups.append(dp.groups)
    return np.concatenate(all_data), np.concatenate(all_groups)


def _check_groups(op, result, data, groups, qmin, qmax):
    assert set(result) == {tuple(g) for g in st.group_grid(GROUP_BY)}
    for g, r in result.items():
        sub = data[np.all(groups == np.asarray(g)[None, :], axis=-1)]
        if op == "sum":
            assert r == int(sub.sum()), g
        elif op == "mean":
            assert (r is None if sub.size == 0
                    else r == pytest.approx(float(sub.mean()))), g
        else:
            assert r == {v: int((sub == v).sum())
                         for v in range(qmin, qmax + 1)}, g


@pytest.mark.parametrize("op", [
    "sum",
    pytest.param("mean", marks=pytest.mark.slow),
    pytest.param("frequency_count", marks=pytest.mark.slow)])
def test_grouped_survey_equals_the_cleartext(cluster, op):
    rows, qmin, qmax = 20, 0, 9
    data, groups = _feed_groups(cluster, rows, qmin, qmax, seed=5)
    sq = cluster.generate_survey_query(op, query_min=qmin, query_max=qmax,
                                       group_by=GROUP_BY)
    res = cluster.run_survey(sq)
    n_vals = 6 * st.output_size(op, qmin, qmax)
    assert res.decrypted.values.shape == (n_vals,)
    _check_groups(op, res.result, data, groups, qmin, qmax)


def test_cutting_factor_replicas_equal_the_uncut_answer(cluster,
                                                        monkeypatch):
    """cf = 2: every value made twice; both replicas decrypt equal, and the
    first is decoded: the clear aggregate, which is the cf = 1 answer."""
    rng = np.random.default_rng(8)
    for dp in cluster.dps.values():
        dp.data, dp.groups = rng.integers(0, 10, size=(20,)), None
    clear = sum(st.encode_clear("variance", dp.data, 0, 9)
                for dp in cluster.dps.values()).numpy()
    full = []
    decrypt = cluster._decrypt
    monkeypatch.setattr(cluster, "_decrypt",
                        lambda sw: full.append(decrypt(sw)) or full[-1])
    sq = cluster.generate_survey_query("variance", query_min=0, query_max=9,
                                       cutting_factor=2)
    assert sq.query.operation.nbr_output == 6
    cut = cluster.run_survey(sq)
    assert full[0].values.shape == (6,) and full[0].found.all()
    np.testing.assert_array_equal(full[0].values[:3], full[0].values[3:])
    np.testing.assert_array_equal(cut.decrypted.values, clear)
    s_, n, ss = (int(t) for t in clear)
    assert cut.result == pytest.approx(ss / n - (s_ / n) ** 2)


def test_refusals_raise_the_references_value_error(cluster):
    with pytest.raises(ValueError, match="group_by is not supported"):
        cluster.generate_survey_query("log_reg", group_by=GROUP_BY,
                                      lr_params=lr.LRParams())
    with pytest.raises(ValueError, match="cutting_factor > 1 with group_by"):
        cluster.generate_survey_query("sum", query_min=0, query_max=9,
                                      proofs=1, cutting_factor=2,
                                      group_by=GROUP_BY)
    # proofs off, the two combine: values tile group-major, then by cf
    sq = cluster.generate_survey_query("sum", query_min=0, query_max=9,
                                       cutting_factor=2, group_by=GROUP_BY)
    assert sq.query.n_groups() == 6 and sq.query.operation.nbr_output == 2


@pytest.mark.slow
def test_grouped_survey_with_proofs_commits_a_clean_block():
    """Proofs on, 2 CNs, 2 DPs, 2 VNs: the range proofs of 6 groups x 3
    values, each against its tiled spec, all BM_TRUE; the same per-group
    counts as the clear data."""
    c = LocalCluster(n_cns=2, n_dps=2, n_vns=2, seed=4, dlog_limit=1000,
                     device="cpu")
    try:
        data, groups = _feed_groups(c, 12, 0, 2, seed=9)
        sq = c.generate_survey_query("frequency_count", query_min=0,
                                     query_max=2, proofs=1,
                                     ranges=[(4, 2)] * 3, group_by=GROUP_BY)
        assert c._ranges_per_value(sq.query) == [(4, 2)] * 18
        res = c.run_survey(sq)
        bitmap = res.block.data.bitmap
        assert len(bitmap) == 2 * (2 + 2 + 2)
        assert set(bitmap.values()) == {rq.BM_TRUE}
        _check_groups("frequency_count", res.result, data, groups, 0, 2)
    finally:
        c.close()
