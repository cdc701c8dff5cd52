"""Cross-survey crypto pools: persistent DRO precompute + sig tables.

The port's counterpart of drynx_tpu/pool/__init__.py. See store.py for
the disk format and the single-consumption claim protocol (load-bearing
privacy), replenish.py for the refill crypto.

Process-wide active pool: both tenants are CONTENT-ADDRESSED (DRO slabs
by collective-key digest, sig tables by A-table digest), so one shared
pool can never serve an artifact to the wrong key/signature set — which
makes a process-global handle safe. ``LocalCluster(pool=...)`` activates
its pool here so deep call sites with no cluster in scope (the fixed-base
and sig-table builds of crypto/elgamal.py and proofs/range_proof.py) can
consult the store, and its ``close()`` clears it again. Only ``activate``
sets the active pool: the reference's ``DRYNX_POOL_DIR`` fallback is not
ported.
"""
from __future__ import annotations

from .store import (CryptoPool, DoubleConsumption, InsufficientBalance,
                    PoolError, key_digest)
from .epsilon import EpsilonExhausted, EpsilonLedger
from . import replenish

_ACTIVE: CryptoPool | None = None


def activate(pool: CryptoPool | None) -> CryptoPool | None:
    """Install ``pool`` as the process-wide active pool (None clears)."""
    global _ACTIVE
    _ACTIVE = pool
    return pool


def active_pool() -> CryptoPool | None:
    """The pool set with ``activate``, else None."""
    return _ACTIVE


__all__ = ["CryptoPool", "PoolError", "DoubleConsumption",
           "InsufficientBalance", "key_digest", "replenish",
           "activate", "active_pool", "EpsilonLedger", "EpsilonExhausted"]
