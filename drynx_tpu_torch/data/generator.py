"""Test-data generation: a valid instance of each of the five proof types,
and a synthetic label-first classification CSV.

The port's counterpart of drynx_tpu/data/generator.py.
`create_random_good_test_data` mirrors the reference Go system's
data/data.go:27-107 (VN verification exercised without a survey). Its
values come from numpy's default_rng(seed), as the reference's do; its
scalars come from an explicit torch.Generator, so its bytes are the
port's own, not the reference's jax.random draws. The dataset helper
writes the reference's label-first format
(lib/encoding/logistic_regression.go:1275 LoadData) byte for byte.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def create_random_good_test_data(cluster, n_values: int = 2, u: int = 4,
                                 l: int = 2, seed: int = 0,
                                 generator: Optional[torch.Generator] = None
                                 ) -> dict:
    """One valid proof of each type against `cluster`'s keys, on its
    device.

    Returns {"range": bytes, "aggregation": bytes, "obfuscation": bytes,
    "keyswitch": bytes, "shuffle": bytes}, each the payload of a
    ProofRequest of that type. Values and the shuffle's permutation and
    scalars come from default_rng(seed), every other scalar from
    `generator` (None: a generator on the cluster's device seeded with
    `seed`)."""
    import pickle

    from ..crypto import curve as C
    from ..crypto import elgamal as eg
    from ..crypto import field as F
    from ..proofs import aggregation as agg_proof
    from ..proofs import keyswitch as ks_proof
    from ..proofs import obfuscation as obf_proof
    from ..proofs import range_proof as rp
    from ..proofs import shuffle as shuffle_proof

    dev = cluster.device
    rng = np.random.default_rng(seed)
    gen = (generator if generator is not None
           else torch.Generator(device=dev).manual_seed(seed))
    base, coll = cluster.base_table, cluster.coll_tbl.table

    def encrypt(vals):
        vals = torch.as_tensor(vals, dtype=torch.int64, device=dev)
        rs = eg.random_scalars(tuple(vals.shape), gen, dev)
        return eg.encrypt_ints_with_tables(base, coll, vals, rs), rs

    out = {}
    # range
    sigs = cluster.ensure_range_sigs(u)
    vals = rng.integers(0, u ** l, size=(n_values,)).astype(np.int64)
    cts, rs = encrypt(vals)
    out["range"] = rp.RangeProofList(
        n_values=n_values,
        batches=[(np.arange(n_values, dtype=np.int64),
                  rp.create_range_proofs(vals, rs, cts, sigs, u, l, coll,
                                         generator=gen))]).to_bytes()

    # aggregation
    many, _ = encrypt(rng.integers(0, 9, size=(3, n_values)))
    agg = eg.ct_add(eg.ct_add(many[0], many[1]), many[2])
    out["aggregation"] = pickle.dumps(
        agg_proof.create_aggregation_proof(many, agg))

    # obfuscation
    s = eg.random_scalars((n_values,), gen, dev)
    out["obfuscation"] = pickle.dumps(
        obf_proof.create_obfuscation_proofs(cts, s, generator=gen))

    # keyswitch
    ks_rs = eg.random_scalars((len(cluster.cns), n_values), gen, dev)
    srv_x, u_pts, w_pts, _ = cluster._key_switch(cts, ks_rs)
    out["keyswitch"] = pickle.dumps(ks_proof.create_keyswitch_proofs(
        cts[:, 0], srv_x, ks_rs, cluster.client_pt, cluster.client_tbl.table,
        u_pts, w_pts, generator=gen))

    # shuffle
    perm = rng.permutation(n_values)
    betas = [int(rng.integers(1, 1 << 62)) for _ in range(n_values)]
    rs2 = F.from_int(betas).to(dev)
    zero_ct = torch.stack([eg.fixed_base_mul(base, rs2),
                           eg.fixed_base_mul(coll, rs2)], dim=-3)
    out_cts = eg.ct_add(cts[torch.from_numpy(perm).to(dev)], zero_ct)
    pr = shuffle_proof.prove_shuffle(
        cts, out_cts, perm, betas, C.from_ref(cluster.coll_pub).to(dev), rng)
    out["shuffle"] = pickle.dumps((pr, cts.cpu().numpy(),
                                   out_cts.cpu().numpy()))
    return out


def synthetic_classification_csv(path: str, n: int = 200, d: int = 8,
                                 seed: int = 0, sep: str = ",") -> None:
    """Write a label-first CSV shaped like the reference's Pima-format data
    files (label column first, integer-ish features)."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(d,))
    X = rng.normal(loc=4.0, scale=2.0, size=(n, d))
    logits = (X - X.mean(0)) @ w
    y = (logits + rng.logistic(size=n) > 0).astype(int)
    with open(path, "w") as f:
        for i in range(n):
            f.write(sep.join([str(y[i])] + [f"{v:.3f}" for v in X[i]]) + "\n")


__all__ = ["create_random_good_test_data", "synthetic_classification_csv"]
