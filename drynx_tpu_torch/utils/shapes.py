"""Shape arithmetic for the crypto modules' batched wrappers."""
from __future__ import annotations


def broadcast_shape(*shapes) -> tuple:
    """The broadcast of integer shapes, as `torch.broadcast_shapes` gives
    it (a RuntimeError where they do not broadcast), in plain Python:
    `torch.broadcast_shapes` imports sympy on its first call, which cost a
    cold process 3.6-4.4 s inside its first survey on an H100 machine's
    host (scripts/torch_warm_cost.py --trace)."""
    n = max((len(s) for s in shapes), default=0)
    out = [1] * n
    for s in shapes:
        for i, d in enumerate(s, n - len(s)):
            d = int(d)
            if d == 1:
                continue
            if out[i] not in (1, d):
                raise RuntimeError(f"shapes {[tuple(x) for x in shapes]} "
                                   f"do not broadcast")
            out[i] = d
    return tuple(out)


__all__ = ["broadcast_shape"]
