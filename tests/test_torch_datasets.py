"""The port's data/ package against the reference's, on the CPU.

`data/datasets.py` is the reference's numpy code: `generate` gives equal
arrays for every shape and a few seeds; `write_csv`, `clean` and the
`gen`/`clean` CLI write byte-equal files; `synthetic_classification_csv`
writes a byte-equal file; `load_label_csv` reads them as the reference's
does. The reference-shaped LR datasets go through the port's loader and
encoder as the reference test (tests/test_lr_datasets.py) takes them.

Marked slow (a CPU cluster's plain ladders and pairings, ~minutes):
`create_random_good_test_data`'s five payloads against a port
`LocalCluster` on the CPU, each accepted by the port's verifier for its
type, and the range payload with one Zv byte changed rejected.
"""

import numpy as np
import pytest
import torch

from drynx_tpu.data import datasets as JD
from drynx_tpu.data import generator as JG
from drynx_tpu.models import logreg as JLR
from drynx_tpu_torch import data as TDATA
from drynx_tpu_torch.data import datasets as TD
from drynx_tpu_torch.data import generator as TG
from drynx_tpu_torch.models import logreg as TLR


@pytest.mark.parametrize("name", sorted(JD.SHAPES))
def test_generate_equals_the_reference(name):
    assert TD.SHAPES[name] == JD.SHAPES[name]
    for seed in (0, 3, 11):
        X, y = TD.generate(name, seed)
        Xr, yr = JD.generate(name, seed)
        assert np.array_equal(X, Xr) and np.array_equal(y, yr)
        assert X.shape == (JD.SHAPES[name]["n"], JD.SHAPES[name]["d"])
    assert TD.SHAPES.keys() == JD.SHAPES.keys()


def test_csv_files_and_clean_equal_the_reference(tmp_path):
    X, y = TD.generate("pima", 3)
    TD.write_csv(str(tmp_path / "t.csv"), X, y)
    JD.write_csv(str(tmp_path / "j.csv"), X, y)
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()
    # a float-valued file takes the other format
    TD.write_csv(str(tmp_path / "tf.csv"), X / 3, y, sep=";")
    JD.write_csv(str(tmp_path / "jf.csv"), X / 3, y, sep=";")
    assert (tmp_path / "tf.csv").read_bytes() == (tmp_path / "jf.csv").read_bytes()
    Xl, yl = TDATA.load_label_csv(str(tmp_path / "t.csv"))
    Xj, yj = JLR.load_csv(str(tmp_path / "t.csv"))
    assert np.array_equal(Xl, Xj) and np.array_equal(yl, np.asarray(yj))
    assert np.allclose(Xl, X) and np.array_equal(yl, y)
    # clean: NaN rows, sentinels, label binarization
    Xd = X[:20].copy()
    Xd[2, 1] = np.nan
    Xd[5, 0] = -9
    yd = np.where(y[:20] == 1, 2, 7)
    for kw in ({}, {"missing_sentinels": (-9,)},
               {"missing_sentinels": (-9, 0), "label_true": 2}):
        a, b = TD.clean(Xd, yd, **kw), JD.clean(Xd, yd, **kw)
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


def test_the_cli_writes_the_references_files(tmp_path):
    assert TD.main(["gen", "--name", "spectf", "--seed", "3", "--out",
                    str(tmp_path / "t.csv")]) == 0
    assert JD.main(["gen", "--name", "spectf", "--seed", "3", "--out",
                    str(tmp_path / "j.csv")]) == 0
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()
    raw = np.loadtxt(tmp_path / "t.csv", delimiter=",")
    raw[4, 3] = -9
    np.savetxt(tmp_path / "raw.csv", raw, delimiter=",", fmt="%d")
    for mod, out in ((TD, "tc.csv"), (JD, "jc.csv")):
        assert mod.main(["clean", "--input", str(tmp_path / "raw.csv"),
                         "--out", str(tmp_path / out), "--missing", "-9",
                         "--label-true", "1"]) == 0
    assert (tmp_path / "tc.csv").read_bytes() == (tmp_path / "jc.csv").read_bytes()
    assert len((tmp_path / "tc.csv").read_text().splitlines()) == 266


def test_synthetic_classification_csv_equals_the_reference(tmp_path):
    for kw in ({}, {"n": 31, "d": 3, "seed": 7, "sep": ";"}):
        TG.synthetic_classification_csv(str(tmp_path / "t.csv"), **kw)
        JG.synthetic_classification_csv(str(tmp_path / "j.csv"), **kw)
        assert (tmp_path / "t.csv").read_bytes() == \
            (tmp_path / "j.csv").read_bytes()


@pytest.mark.parametrize("name,precision,n_coeffs", [
    ("pima", 1.0, 90), ("pcs", 0.1, 56), ("spectf", 0.1, 2070)])
def test_reference_shaped_lr_stats_equal_the_references(name, precision,
                                                        n_coeffs):
    """The LR parameters of tests/test_lr_datasets.py:63-67 and :158-163 on
    the port's datasets: each DP's integer statistics equal the
    reference's encoder's on the same rows."""
    X, y = TD.generate(name, seed=3)
    kw = dict(k=2, precision=precision, lambda_=1.0, step=0.1,
              max_iterations=100, n_features=X.shape[1], n_records=len(y),
              means=tuple(np.mean(X, 0)), std_devs=tuple(np.std(X, 0)))
    tp, jp = TLR.LRParams(**kw), JLR.LRParams(**kw)
    assert tp.num_coeffs() == jp.num_coeffs() == n_coeffs
    for i in (0, 4):
        Xi, yi = TLR.shard_for_dp(X, y, i, 5)
        assert np.array_equal(TLR.encode_clear(Xi, yi, tp).numpy(),
                              np.asarray(JLR.encode_clear(Xi, yi, jp)))


@pytest.mark.slow
def test_random_good_test_data_is_accepted_by_the_ports_verifiers():
    from drynx_tpu_torch.proofs import aggregation as agg_proof
    from drynx_tpu_torch.proofs import keyswitch as ks_proof
    from drynx_tpu_torch.proofs import obfuscation as obf_proof
    from drynx_tpu_torch.proofs import range_proof as rp
    from drynx_tpu_torch.proofs import shuffle as shuffle_proof
    from drynx_tpu_torch.proofs.safe_pickle import safe_loads
    from drynx_tpu_torch.service.service import LocalCluster

    torch.set_num_threads(1)
    cluster = LocalCluster(n_cns=2, n_dps=1, n_vns=1, seed=3, device="cpu")
    try:
        out = TG.create_random_good_test_data(cluster, n_values=2, u=4, l=2,
                                              seed=0)
        assert set(out) == {"range", "aggregation", "obfuscation",
                            "keyswitch", "shuffle"}
        # the same seed gives the same bytes
        again = TG.create_random_good_test_data(cluster, seed=0)
        assert again["range"] == out["range"]
        sigs_pub = {4: [s.public for s in cluster.range_sigs[4]]}
        tbl = cluster.coll_tbl.table
        lst = rp.RangeProofList.from_bytes(out["range"], "cpu")
        assert rp.verify_range_proof_list(lst, [(4, 2)] * 2, sigs_pub, tbl)
        assert np.all(agg_proof.verify_aggregation_proof(
            safe_loads(out["aggregation"])))
        assert np.all(obf_proof.verify_obfuscation_proofs(
            safe_loads(out["obfuscation"])))
        assert np.all(ks_proof.verify_keyswitch_proofs(
            safe_loads(out["keyswitch"]), cluster.client_tbl.table))
        pr, a, b = safe_loads(out["shuffle"])
        assert shuffle_proof.verify_shuffle(
            pr, torch.from_numpy(a), torch.from_numpy(b), cluster.coll_pt)
        # one Zv byte changed: rejected
        bad = rp.RangeProofList.from_bytes(out["range"], "cpu")
        bad.batches[0][1].zv[0, 1, 1, 0] ^= 1
        assert not rp.verify_range_proof_list(bad, [(4, 2)] * 2, sigs_pub,
                                              tbl)
    finally:
        cluster.close()
