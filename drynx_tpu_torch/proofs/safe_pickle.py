"""Restricted unpickling for network-received proof payloads.

The port's counterpart of drynx_tpu/proofs/safe_pickle.py. Verifying nodes
deserialize proof bodies sent by the very parties they exist to distrust;
a plain `pickle.loads` on attacker-controlled bytes runs whatever callable
a crafted `__reduce__` names. This module allows only the value types
proofs legitimately contain: numpy arrays and the proof dataclasses of
this package, each by its exact name. torch is not allowed: its pickle
globals include arbitrary callables, so the port's proof dataclasses pickle
their tensors as CPU numpy arrays and the verifier moves them to its
device.

(The range-proof payload has its own fixed-layout byte codec and never goes
through pickle; aggregation, obfuscation, key-switch and shuffle bodies use
this.)
"""
from __future__ import annotations

import dataclasses
import io
import pickle

import torch

# The only globals a proof payload may name, as exact (module, name) pairs:
# numpy's array reconstructors (protocol 4 and protocol 5, under numpy 2's
# `_core` and numpy 1's `core` spelling), ndarray and dtype, and the proof
# dataclasses. Roots are not allowed wholesale: the unpickler resolves
# a dotted name inside an allowed module, so any module of this package
# would hand out what it imports (`os.system`, `torch.load`).
_ALLOWED = {
    *((f"numpy.{core}.multiarray", "_reconstruct") for core in ("_core",
                                                                "core")),
    *((f"numpy.{core}.numeric", "_frombuffer") for core in ("_core",
                                                            "core")),
    ("numpy", "ndarray"),
    ("numpy", "dtype"),
    ("drynx_tpu_torch.proofs.aggregation", "AggregationProofBatch"),
    ("drynx_tpu_torch.proofs.keyswitch", "KeySwitchProofBatch"),
    ("drynx_tpu_torch.proofs.obfuscation", "ObfuscationProofBatch"),
    ("drynx_tpu_torch.proofs.shuffle", "ShuffleProof"),
    ("drynx_tpu_torch.proofs.shuffle", "ILMPPProof"),
}


class _RestrictedUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if "." not in name and (module, name) in _ALLOWED:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"proof payload references forbidden global {module}.{name}")


def safe_loads(data: bytes):
    """pickle.loads restricted to proof-shaped content; raises
    pickle.UnpicklingError on anything else."""
    return _RestrictedUnpickler(io.BytesIO(data)).load()


class TensorState:
    """Pickle mixin for the proof dataclasses: tensor fields travel as CPU
    numpy arrays and come back as CPU tensors, so a payload names no torch
    global."""

    def __getstate__(self) -> dict:
        return {f.name: (v.cpu().numpy() if isinstance(v, torch.Tensor)
                         else v)
                for f in dataclasses.fields(self)
                for v in [getattr(self, f.name)]}

    def __setstate__(self, state: dict) -> None:
        import numpy as np

        for k, v in state.items():
            setattr(self, k, torch.from_numpy(np.array(v))
                    if isinstance(v, np.ndarray) else v)

    def to(self, device):
        """A copy with every tensor field on `device`."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


__all__ = ["safe_loads", "TensorState"]
