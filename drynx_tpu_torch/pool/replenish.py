"""Pool replenishment: compute DRO precompute slabs and deposit them.

The port's counterpart of drynx_tpu/pool/replenish.py. This is the crypto
half of the pool (store.py stays numpy-only): a refill step runs
``parallel.dro.precompute_rerandomization`` at the pool's slab width on
the device of the collective-key table and deposits the result, as host
uint32 arrays, under the table's digest. Randomness comes from a
``torch.Generator`` that the caller passes and that each slab advances,
so a slab's blinding scalars never repeat within one generator.
"""
from __future__ import annotations

import torch

from . import store as _store


def refill_slab(pool: _store.CryptoPool, generator: torch.Generator,
                pub_tbl_table, elems: int | None = None) -> str:
    """Compute + deposit ONE slab of fresh zero-encryptions; returns the
    slab id. ``pub_tbl_table`` is the RAW collective-key fixed-base table
    (FixedBase.table) on the device that computes the slab."""
    from ..parallel import dro

    elems = int(elems or pool.slab_elems)
    zero_ct, r = dro.precompute_rerandomization(pub_tbl_table, elems,
                                                generator)
    digest = _store.key_digest(pub_tbl_table)
    return pool.deposit_dro(digest, zero_ct, r)


def refill_to(pool: _store.CryptoPool, generator: torch.Generator,
              pub_tbl_table, target_elems: int,
              max_slabs: int | None = None) -> int:
    """Deposit slabs until the balance covers ``target_elems`` (or
    ``max_slabs`` is hit); returns the number of slabs deposited."""
    digest = _store.key_digest(pub_tbl_table)
    n = 0
    while pool.dro_balance(digest) < target_elems:
        if max_slabs is not None and n >= max_slabs:
            break
        refill_slab(pool, generator, pub_tbl_table)
        n += 1
    return n


__all__ = ["refill_slab", "refill_to"]
