"""Flagship pipeline: the encrypted logistic-regression survey, on one device.

The port's counterpart of drynx_tpu/flagship.py (single-device half). Every
DP encodes and encrypts its local approximation tensors, the ciphertexts are
aggregated homomorphically, the computing nodes key-switch the aggregate to
the querier, the querier decrypts through the discrete-log table and trains
by gradient descent. The server and DP loops are batch axes, so on the card
the whole survey is five fixed-base, two variable-base, three reduce, four
add and one inversion kernel launch, plus torch glue and the GD loop.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .crypto import elgamal as eg
from .crypto import cuda_ops
from .models import logreg as lr
from .parallel import collective as col
from .utils.device import resolve


@dataclasses.dataclass
class SurveySetup:
    """Keys and tables of one survey: n_servers CNs and a querier, on one
    device."""

    server_secrets: torch.Tensor    # (n_servers, 16) int32 scalar limbs
    coll_pub_table: torch.Tensor    # (64, 16, 3, 16) int32 fixed-base table
    query_secret: int
    query_pub_table: torch.Tensor
    dlog: eg.DecryptionTable
    device: torch.device

    @classmethod
    def create(cls, n_servers: int = 3, dlog_limit: int = 10000, seed: int = 4,
               device=None):
        """Keygen from a numpy seed: the same draws, and so the same keys
        and tables byte for byte, as the reference's SurveySetup.create."""
        dev = resolve(device)
        rng = np.random.default_rng(seed)
        secrets, pubs = zip(*[eg.keygen(rng) for _ in range(n_servers)])
        coll = col.collective_key(pubs)
        qx, qpub = eg.keygen(rng)
        return cls(
            server_secrets=torch.stack(
                [eg.secret_to_limbs(x) for x in secrets]).to(dev),
            coll_pub_table=eg.pub_table(coll).table.to(dev),
            query_secret=qx,
            query_pub_table=eg.pub_table(qpub).table.to(dev),
            dlog=eg.DecryptionTable(limit=dlog_limit).to(dev),
            device=dev,
        )

    @classmethod
    def from_numpy(cls, server_secrets, coll_pub_table, query_secret: int,
                   query_pub_table, dlog_keys, dlog_xs, dlog_ysign, dlog_vals,
                   device=None):
        """A setup from another's arrays (e.g. the reference's, as numpy):
        server secret limbs, both fixed-base tables, the querier's secret
        and the sorted discrete-log table."""
        dev = resolve(device)
        as_i32 = lambda a: torch.as_tensor(np.asarray(a).astype(np.int32),
                                           device=dev)
        dlog = eg.DecryptionTable.from_arrays(dlog_keys, dlog_xs, dlog_ysign,
                                              dlog_vals)
        return cls(server_secrets=as_i32(server_secrets),
                   coll_pub_table=as_i32(coll_pub_table),
                   query_secret=int(query_secret),
                   query_pub_table=as_i32(query_pub_table),
                   dlog=dlog.to(dev), device=dev)


def _tree_reduce_points(pts):
    """Group-add reduce of axis 0 of a point or ciphertext tensor: one
    launch of the reduce kernel."""
    if pts.shape[0] == 1:
        return pts[0]
    mid = pts.shape[1:-2]
    out = cuda_ops.point_reduce_flat(pts.reshape(pts.shape[0], -1, 3, 16))
    return out.reshape(mid + (3, 16))


def build_pipeline(setup: SurveySetup, params: lr.LRParams):
    """The survey as one function on the setup's device.

    Returns fn(dp_stats, enc_rs, ks_rs) -> (weights, dec_ints, found):
      dp_stats: int64 (n_dps, V) local fixed-point stat vectors
      enc_rs:   int32 (n_dps, V, 16) encryption blinding scalars
      ks_rs:    int32 (n_servers, V, 16) key-switch randomness
    """
    dev = setup.device
    base_tbl = eg.BASE_TABLE.table.to(dev)
    coll_tbl = setup.coll_pub_table
    q_tbl = setup.query_pub_table
    srv_x = setup.server_secrets
    qx = eg.secret_to_limbs(setup.query_secret).to(dev)
    dl = setup.dlog

    def fn(dp_stats, enc_rs, ks_rs):
        dp_stats, enc_rs, ks_rs = (t.to(dev) for t in (dp_stats, enc_rs, ks_rs))
        # DP side: every stat of every DP in one batch
        cts = eg.encrypt_ints_with_tables(base_tbl, coll_tbl, dp_stats, enc_rs)
        # collective aggregation
        agg = _tree_reduce_points(cts)
        # key switch: all servers' contributions in one batch, then reduce
        kc, cc = col.keyswitch_contribution(agg[None], srv_x[:, None, :],
                                            ks_rs, q_tbl, base_tbl)
        switched = col.keyswitch_finish(agg, _tree_reduce_points(kc),
                                        _tree_reduce_points(cc))
        # querier: decrypt, discrete log, gradient descent
        pts = eg.decrypt_point(switched, qx)
        dec, found = dl.lookup(pts)
        w = lr.train(lr.unpack(dec, params), params)
        return w, dec, found

    return fn


def make_inputs(X, y, params: lr.LRParams, num_dps: int = 10,
                n_servers: int = 3, seed: int = 0, device=None):
    """Per-DP stats and the survey's randomness, drawn from a torch
    generator seeded with `seed`: (stats, enc_rs, ks_rs) on the device."""
    dev = resolve(device)
    stats = torch.stack([
        lr.encode_clear(*lr.shard_for_dp(X, y, i, num_dps), params)
        for i in range(num_dps)]).to(dev)
    gen = torch.Generator().manual_seed(seed)
    V = stats.shape[1]
    enc_rs = eg.random_scalars((num_dps, V), gen, dev)
    ks_rs = eg.random_scalars((n_servers, V), gen, dev)
    return stats, enc_rs, ks_rs


def pima_shaped_problem(num_dps: int = 10, n_records: int = 768, d: int = 8,
                        max_iterations: int = 450):
    """The Pima-shaped problem of the reference's benchmark: n_records
    distinct rows per DP, d features, K=2, max_iterations GD steps, float32
    training."""
    X, y = lr.synthetic_dataset(n=n_records * num_dps, d=d, seed=13)
    p = lr.LRParams(
        k=2, precision=1.0, lambda_=1.0, step=0.1,
        max_iterations=max_iterations, n_features=d,
        n_records=len(y), dtype="float32",
        means=tuple(np.mean(X, 0)), std_devs=tuple(np.std(X, 0)))
    return X, y, p


def entry(device=None):
    """The reference's single-chip entry on the port: the full survey on a
    small Pima-shaped problem (4 DPs x 64 records, d=3, 3 servers, 20 GD
    steps). Returns (fn, (stats, enc_rs, ks_rs))."""
    dev = resolve(device)
    num_dps, n_servers = 4, 3
    X, y, params = pima_shaped_problem(num_dps=num_dps, n_records=64, d=3,
                                       max_iterations=20)
    setup = SurveySetup.create(n_servers=n_servers, dlog_limit=500, device=dev)
    fn = build_pipeline(setup, params)
    return fn, make_inputs(X, y, params, num_dps, n_servers, device=dev)


__all__ = ["SurveySetup", "build_pipeline", "make_inputs",
           "pima_shaped_problem", "entry"]
