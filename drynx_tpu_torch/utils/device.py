"""Where the port's entry points run."""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """`None` means the card. Raises when the card is asked for (or implied)
    and CUDA is absent; the CPU runs only when the caller names it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "drynx_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch versions")
    return dev


__all__ = ["resolve"]
