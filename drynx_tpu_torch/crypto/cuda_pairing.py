"""CUDA kernels of the pairing module, each beside its plain PyTorch version.

The port's counterpart of drynx_tpu/crypto/pallas_pairing.py. This slice
holds only the kernel that the encrypted survey's main path runs:

  fp_inv_flat  replaces pallas_pairing._fp_inv_kernel (csrc/fp_inv.cu)

`curve.normalize` calls it to bring Jacobian points to affine before the
discrete-log lookup. The wrapper follows the rules of `cuda_ops`: on a CUDA
tensor it launches the kernel and counts the launch in `LAUNCHES`, on a CPU
tensor it runs the plain version. The reference squares and multiplies for
every bit of p - 2 and selects; both versions here multiply only where a bit
is set, since the exponent is public, and reach the same residue. What bounds
the kernel is noted at the top of `csrc/fp_inv.cu`.
"""
from __future__ import annotations

import torch

from ..utils import cuda_build
from . import field as F
from .field import FP
from .params import NUM_LIMBS

LAUNCHES = {"fp_inv": 0}


def fp_inv_plain(x):
    """x^(p-2) per element, (N, 16) Montgomery in and out, int32."""
    return F._pow_const64(x.to(torch.int64), FP.modulus - 2, FP).to(torch.int32)


def fp_inv_flat(x):
    """x^(p-2) batched: (N, 16) Montgomery -> (N, 16) Montgomery."""
    if x.dtype != torch.int32:
        raise TypeError(f"x must be int32 limbs, got {x.dtype}")
    if x.dim() != 2 or x.shape[1] != NUM_LIMBS:
        raise ValueError(f"x has shape {tuple(x.shape)}, expected (N, 16)")
    if x.device.type == "cpu":
        return fp_inv_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"no route for tensors on {x.device}")
    n = x.shape[0]
    x = x.contiguous()
    out = torch.empty_like(x)
    if n == 0:
        return out
    lib = cuda_build.load("fp_inv")
    # the runtime launches on the current device: make it the tensor's one
    with torch.cuda.device(x.device):
        rc = lib.fp_inv(x.data_ptr(), out.data_ptr(), n,
                        torch.cuda.current_stream().cuda_stream)
    cuda_build.check(rc, "fp_inv")
    LAUNCHES["fp_inv"] += 1
    return out


__all__ = ["LAUNCHES", "fp_inv_flat", "fp_inv_plain"]
