"""Encrypted collectives: key switching, and the group-law all-reduces
over a mesh of shards.

The port's counterpart of drynx_tpu/parallel/collective.py. Each server's
key-switch contribution is
    K_i = r_i*B,   C_i = r_i*Q - x_i*K
and the contributions commute, so their sums switch the aggregate:
    K_new = sum_i r_i*B,   C_new = C + sum_i (r_i*Q - x_i*K).

The mesh half: a mesh is a tuple of devices (`make_mesh`), and a sharded
value is a list with one tensor a shard, each on its shard's device. One
process drives every shard; `_allreduce` combines the list in the
reference's exact pairing order (the XOR butterfly for a power of two,
the ring otherwise), and every shard ends with the total. Obfuscation by
each server's secret scalar telescopes to one scalar product by the
all-reduced product of the scalars mod n, keeping zero and non-zero.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..crypto import curve as C
from ..crypto import elgamal as eg
from ..crypto import field as F
from ..crypto import refimpl
from ..crypto.field import FN


def make_mesh(n_devices: Optional[int] = None, device=None) -> tuple:
    """A 1-D mesh of `n_devices` shards (None: one a visible CUDA device):
    shard i on cuda:(i mod the visible devices), or every shard on
    `device` when it is named (the CPU, say)."""
    from . import proof_plane as plane

    n = n_devices or max(1, plane.device_count())
    if device is not None:
        return (torch.device(device),) * n
    return tuple(plane.shard_device(i) for i in range(n))


def _allreduce(xs: list, combine) -> list:
    """All-reduce of one tensor a shard with `combine`: the XOR butterfly
    (log2 n rounds, shard i taking shard i ^ k's value) for a power of two,
    else the ring (n - 1 rounds, shard i taking shard i - 1's running
    value). Every shard ends with the total, combined in the reference's
    order on its own device."""
    n = len(xs)
    if n == 1:
        return list(xs)
    if n & (n - 1) == 0:
        k = 1
        while k < n:
            xs = [combine(xs[i], _moved(xs[i ^ k], xs[i]))
                  for i in range(n)]
            k *= 2
        return xs
    acc, cur = list(xs), list(xs)
    for _ in range(n - 1):
        cur = [_moved(cur[(i - 1) % n], cur[i]) for i in range(n)]
        acc = [combine(acc[i], cur[i]) for i in range(n)]
    return acc


def _moved(x, like):
    """x on the device of `like` (the receiving shard's)."""
    return x.to(like.device) if isinstance(x, torch.Tensor) else x


def allreduce_group_add(cts: list) -> list:
    """All-reduce homomorphic sum of one point or ciphertext tensor a
    shard ((..., 3, 16) points; (..., 2, 3, 16) ciphertexts add over
    their leading dims)."""
    return _allreduce(cts, C.add)


def allreduce_scalar_mul(s_plain: list) -> list:
    """All-reduce product mod n of one plain scalar tensor a shard."""
    prod = _allreduce([F.to_mont(s, FN) for s in s_plain],
                      lambda a, b: F.mont_mul(a, b, FN))
    return [F.from_mont(p, FN) for p in prod]


def collective_key(pubs):
    """Sum of server public keys (host affine ints) -> collective pub."""
    acc = None
    for p in pubs:
        acc = refimpl.g1_add(acc, p)
    return acc


def keyswitch_contribution(ct, x_limbs, r_limbs, query_pub_table,
                           base_table=None):
    """One server's (or a batch of servers') key-switch contribution.

    ct: (..., 2, 3, 16) under the collective key; x_limbs: secret scalar
    limbs, broadcastable against ct.shape[:-3]; r_limbs: fresh randomness,
    the broadcast batch + (16,). Returns (K_contrib, C_contrib) points."""
    if base_table is None:
        base_table = eg.BASE_TABLE.table.to(ct.device)
    K = ct[..., 0, :, :]
    xK = C.scalar_mul(K, x_limbs)
    rB = eg.fixed_base_mul(base_table, r_limbs)
    rQ = eg.fixed_base_mul(query_pub_table, r_limbs)
    return rB, C.add(rQ, C.neg(xK))


def keyswitch_finish(ct, k_sum, c_sum):
    """Assemble the switched ciphertext from the summed contributions."""
    C_new = C.add(ct[..., 1, :, :], c_sum)
    return torch.stack([k_sum, C_new], dim=-3)


def keyswitch_collective(cts: list, x_limbs: list, r_limbs: list,
                         query_pub_table) -> list:
    """The key switch over a mesh: shard i's contribution with its secret
    x_i and randomness r_i (zeros contribute the identity), then the
    all-reduces of the K and C contributions, then each shard's switched
    ciphertexts."""
    parts = [keyswitch_contribution(ct, x, r, query_pub_table.to(ct.device))
             for ct, x, r in zip(cts, x_limbs, r_limbs)]
    k_sum = allreduce_group_add([p[0] for p in parts])
    c_sum = allreduce_group_add([p[1] for p in parts])
    return [keyswitch_finish(ct, k, c)
            for ct, k, c in zip(cts, k_sum, c_sum)]


def obfuscate_collective(cts: list, s_limbs: list) -> list:
    """Obfuscation over a mesh: each shard's ciphertexts times the product
    of every shard's scalar (zero stays zero, non-zero stays non-zero)."""
    prods = allreduce_scalar_mul(s_limbs)
    return [eg.ct_scalar_mul(ct, s) for ct, s in zip(cts, prods)]


__all__ = ["make_mesh", "allreduce_group_add", "allreduce_scalar_mul",
           "collective_key", "keyswitch_contribution", "keyswitch_finish",
           "keyswitch_collective", "obfuscate_collective"]
