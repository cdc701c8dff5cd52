"""The range-proof phases of a survey with proofs on, on one device.

The port's counterpart of two steps of drynx_tpu/service/service.py. The
data collection (:727-810, the DP side of `LocalCluster.execute_survey` for
`log_reg` with range proofs): every DP shifts its stats by u^l/2 so that
signed log-reg coefficients become a provable [0, u^l) statement, encrypts
them under the collective key, and proves each ciphertext's range against
the computing nodes' digit signatures, all DPs in one batched creation.
The verifying nodes' check (`vrange_joint`, :254-263): every DP's payload
bytes decoded and checked jointly, one verdict per DP. The cluster around
them (query, aggregation, key switch, transport) is not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from ..crypto import elgamal as eg
from ..proofs import range_proof as rp
from ..utils.device import resolve


def make_range_sigs(u: int, n_servers: int, seed: int = 5,
                    device=None) -> list[rp.RangeSig]:
    """One digit-signature set of base u per computing node, drawn from a
    numpy seed, with its GT tables built on the host and moved to the
    device (the card unless the CPU is named)."""
    dev = resolve(device)
    rng = np.random.default_rng(seed)
    sigs = [rp.init_range_sig(u, rng) for _ in range(n_servers)]
    rp.sig_gt_pow_tables(sigs, dev)    # built here, outside any timed path
    return sigs


def collect_with_range_proofs(dp_stats, enc_rs, ranges, sigs_by_u: dict,
                              coll_pub_table,
                              generator: torch.Generator | None = None,
                              draws: dict | None = None):
    """Encrypt every DP's log-reg stats and prove their ranges, on the
    device of `coll_pub_table`.

    dp_stats: int64 (n_dps, V) fixed-point stats; enc_rs: (n_dps, V, 16)
    encryption blinding scalars; ranges: [(u, l)] per value; sigs_by_u:
    {u: [RangeSig per CN]}; randomness from `generator`, or the draws of
    each (u, l) spec. Returns (cts (n_dps, V, 2, 3, 16), [RangeProofList
    per DP]); DP i's payload is lists[i].to_bytes().
    """
    dev = coll_pub_table.device
    stats = dp_stats.to(dev, torch.int64)
    u0, l0 = ranges[0]
    if u0:
        offset = int(u0) ** int(l0) // 2
        if int(stats.abs().max()) >= offset:
            raise ValueError("log-reg encoding exceeds the range proof "
                             f"bound u^l/2 = {offset}")
        stats = stats + offset
    enc_rs = enc_rs.to(dev)
    cts = eg.encrypt_ints_with_tables(eg.BASE_TABLE.table.to(dev),
                                      coll_pub_table, stats, enc_rs)
    lists = rp.create_range_proof_lists_batched(
        stats, enc_rs, cts, ranges, sigs_by_u, coll_pub_table, generator,
        draws)
    return cts, lists


def verify_collected_range_proofs(payloads, ranges, sigs_by_u: dict,
                                  coll_pub_table) -> list[bool]:
    """The verifying node's joint check of the DPs' range-proof payloads
    (their raw bytes, as `collect_with_range_proofs` serializes them) on
    the device of `coll_pub_table`: one bool per payload. The RLC weights
    are drawn fresh for every call."""
    sigs_pub_by_u = {u: [s.public for s in sigs]
                     for u, sigs in sigs_by_u.items()}
    return rp.verify_range_proof_payloads_joint(payloads, ranges,
                                                sigs_pub_by_u, coll_pub_table)


__all__ = ["make_range_sigs", "collect_with_range_proofs",
           "verify_collected_range_proofs"]
