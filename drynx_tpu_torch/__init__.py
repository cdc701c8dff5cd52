"""drynx_tpu_torch — the PyTorch and CUDA port of drynx_tpu.

The three opt-in runtime recorders of `analysis/` are armed here, before
anything in the package creates a lock or imports torch. They record and
change no result.
"""
import os

# Lock-order recorder (analysis/locktrace.py): patch threading.Lock/RLock
# before any named_lock of the package exists, so every one is traced.
# The cross-check runs a server drain under it and holds the observed
# acquisition order to the static lock-order graph.
if os.environ.get("DRYNX_LOCK_TRACE", "0") == "1":
    from .analysis import locktrace as _locktrace
    _locktrace.install()

# Determinism recorder (analysis/dettrace.py): armed before any
# byte-identity sink (ProofDB.put, transcript serialization, journal
# appends) can fire, so every write of the process is hashed. The
# cross-check runs one proofs-on survey twice with one seed and compares
# the per-sink write multisets.
if os.environ.get("DRYNX_DET_TRACE", "0") == "1":
    from .analysis import dettrace as _dettrace
    _dettrace.install()

# Protocol recorder (analysis/prototrace.py): armed before any resource
# lifecycle (slab consumption, ConnPool checkouts, pane seals, checkpoint
# saves) can fire. The cross-check holds every observed sequence to the
# declared automata.
if os.environ.get("DRYNX_PROTO_TRACE", "0") == "1":
    from .analysis import prototrace as _prototrace
    _prototrace.install()
