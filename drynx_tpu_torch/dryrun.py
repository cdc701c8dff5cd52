"""The flagship survey as one step over a mesh of DP shards.

The port's counterpart of the reference's multi-device dry run
(`__graft_entry__._dryrun_impl`): each shard holds one DP's statistics and
encrypts them on its device; `collective.allreduce_group_add` sums the
ciphertexts so every shard holds the aggregate; `keyswitch_collective`
switches it to the querier's key, the first `n_servers` shards each
contributing one computing node's share and the others the identity (zero
secret, zero randomness); every shard decrypts its copy through the
discrete-log table, and shard 0 trains by gradient descent. One process
drives every shard (`proof_plane.shard_device`), so no child process is
needed.
"""
from __future__ import annotations

import torch

from .crypto import elgamal as eg
from .models import logreg as lr
from .parallel import collective as col


def dryrun_step(setup, params: lr.LRParams, dp_stats, enc_rs, ks_rs,
                mesh=None):
    """One survey over `mesh` (a tuple of devices, one DP a shard; None:
    `collective.make_mesh(n_dps)`).

    setup: a `flagship.SurveySetup` with n_servers computing nodes;
    dp_stats int64 (n_dps, V); enc_rs (n_dps, V, 16); ks_rs
    (n_servers, V, 16), shard i < n_servers using row i. Returns
    (weights, dec_ints, found) of shard 0, after checking that every
    shard decrypted the same integers."""
    n = int(dp_stats.shape[0])
    mesh = col.make_mesh(n) if mesh is None else mesh
    if len(mesh) != n:
        raise ValueError(f"{n} DPs need a mesh of {n} shards, not "
                         f"{len(mesh)}")
    ns = int(setup.server_secrets.shape[0])
    if n < ns:
        raise ValueError(f"{ns} servers need at least {ns} shards")
    cts, xs, rs = [], [], []
    for i, dev in enumerate(mesh):
        r = enc_rs[i].to(dev)
        cts.append(eg.encrypt_ints_with_tables(
            eg.BASE_TABLE.table.to(dev), setup.coll_pub_table.to(dev),
            dp_stats[i].to(dev), r))
        if i < ns:
            xs.append(setup.server_secrets[i].to(dev))
            rs.append(ks_rs[i].to(dev))
        else:
            xs.append(torch.zeros_like(setup.server_secrets[0], device=dev))
            rs.append(torch.zeros_like(r))
    agg = col.allreduce_group_add(cts)
    switched = col.keyswitch_collective(agg, xs, rs, setup.query_pub_table)
    qx = eg.secret_to_limbs(setup.query_secret)
    decs = [setup.dlog.to(ct.device).lookup(
        eg.decrypt_point(ct, qx.to(ct.device))) for ct in switched]
    dec, found = decs[0]
    for i, (d, f) in enumerate(decs[1:], 1):
        if not (torch.equal(d.cpu(), dec.cpu())
                and torch.equal(f.cpu(), found.cpu())):
            raise RuntimeError(f"shard {i} decrypted other integers than "
                               f"shard 0")
    w = lr.train(lr.unpack(dec, params), params)
    return w, dec, found


__all__ = ["dryrun_step"]
