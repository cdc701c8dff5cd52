"""Key-switching of ciphertexts to the querier's key, on one device.

The port's counterpart of the single-device half of
drynx_tpu/parallel/collective.py. Each server's contribution is
    K_i = r_i*B,   C_i = r_i*Q - x_i*K
and the contributions commute, so their sums switch the aggregate:
    K_new = sum_i r_i*B,   C_new = C + sum_i (r_i*Q - x_i*K).
The mesh all-reduces of the reference are not ported yet.
"""
from __future__ import annotations

import torch

from ..crypto import curve as C
from ..crypto import elgamal as eg
from ..crypto import refimpl


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


__all__ = ["collective_key", "keyswitch_contribution", "keyswitch_finish"]
