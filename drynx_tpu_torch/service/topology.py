"""Deterministic roster-derived tree overlay + canonical ciphertext folds.

The reference's 20-machine deployment aggregates *up a tree* (SURVEY §L3:
collective aggregation as an onet tree protocol), while our control plane
dispatched every round as a flat star from the root CN — O(n) fan-in at
one socket endpoint. This module derives a tree purely from the dialed
roster order, so every process (root, relay, client, bench) computes the
identical overlay with zero coordination messages:

  fanout b   = DRYNX_TREE_FANOUT, else clamp(ceil(sqrt(n)),
               TREE_FANOUT_MIN, TREE_FANOUT_MAX)  (depth/width balance)
  roots      = indices [0, b)                      (a forest of b trees)
  children(i)= [(i+1)*b, (i+2)*b) intersect [0, n)
  parent(j)  = j // b - 1                          (for j >= b)

The layout is breadth-first over the *dialed index space*, not over any
contiguous value range: a subtree's members are scattered through the
roster, so correctness of folding rests on the ciphertext group being
abelian — any grouping of the mod-p point additions yields the same group
element. Identical *bytes*, however, need one more step: Jacobian points
carry projective slack (the same group element has many (X, Y, Z) limb
representations, and a reduction produces different Z's under
different fold shapes). :func:`canon_points` erases that slack by
normalizing every point to its unique affine-with-z=1 Montgomery form
(infinity pinned to (1, 1, 0)), so canon(fold(any grouping)) is
byte-identical.

DRYNX_TOPOLOGY=star is the kill-switch back to flat fan-out.

The port's counterpart of drynx_tpu/service/topology.py: the layout half
is a copy; `canon_points` and `fold_cts` run on the port's kernels (the
Fp inversion of `curve.normalize`, the reduce of `cuda_ops`) and give the
reference's bytes.
"""
from __future__ import annotations

import math
import os

import torch

from ..crypto import curve as C
from ..crypto import cuda_ops
from ..crypto.field import FP
from ..resilience import policy as rp

ENV_TOPOLOGY = "DRYNX_TOPOLOGY"
ENV_FANOUT = "DRYNX_TREE_FANOUT"


def topology_mode() -> str:
    """"tree" (default) or "star" (the DRYNX_TOPOLOGY=star kill-switch).
    Unrecognized values fall back to tree so a typo degrades to the
    default instead of silently inventing a third mode."""
    if os.environ.get(ENV_TOPOLOGY, "").strip().lower() == "star":
        return "star"
    return "tree"


def tree_fanout(n: int) -> int:
    """Branching factor for an n-entry roster. DRYNX_TREE_FANOUT
    overrides; auto is ceil(sqrt(n)) clamped to the policy bounds —
    sqrt balances tree depth against per-relay fan-in, the cap keeps one
    relay's concurrent child RPCs in FAN_OUT_WORKERS territory."""
    env = os.environ.get(ENV_FANOUT, "").strip()
    if env:
        return max(1, int(env))
    if n <= 1:
        return 1
    auto = math.ceil(math.sqrt(n))
    return max(rp.TREE_FANOUT_MIN, min(auto, rp.TREE_FANOUT_MAX))


def roots(n: int, b: int) -> list[int]:
    """Top-level indices the dispatching root contacts directly."""
    return list(range(min(b, n)))


def children(i: int, n: int, b: int) -> list[int]:
    """Direct children of index i in the breadth-first overlay."""
    lo, hi = (i + 1) * b, (i + 2) * b
    return list(range(min(lo, n), min(hi, n)))


def parent(i: int, b: int):
    """Parent index of i, or None for the forest roots [0, b)."""
    return None if i < b else i // b - 1


def subtree(i: int, n: int, b: int) -> list[int]:
    """Every index in the subtree rooted at i (preorder, i first)."""
    out, stack = [], [i]
    while stack:
        j = stack.pop()
        out.append(j)
        stack.extend(reversed(children(j, n, b)))
    return out


def survivor_layout(order: list, alive) -> list:
    """Re-plan the overlay after mid-survey failures: the roster that a
    fresh breadth-first tree should be built over, i.e. the surviving
    names in original roster order. Compacting the dead indices out is
    the whole failover — a dead interior relay's former descendants land
    under live parents in the re-derived ``children()`` arithmetic, and
    keeping roster order (not heal order) makes the re-planned layout a
    pure function of WHICH nodes healed, never of when their probes
    returned. Used by the root's re-entry pass (node.py
    ``_redispatch_missing``) to dispatch only the missing sub-work."""
    live = set(alive)
    return [nm for nm in order if nm in live]


def depth(n: int, b: int) -> int:
    """Number of levels in the overlay (1 = pure star of roots)."""
    d, level = 0, list(range(min(b, n)))
    while level:
        d += 1
        level = [c for i in level for c in children(i, n, b)]
    return d


# ---------------------------------------------------------------------------
# Canonical folds
# ---------------------------------------------------------------------------

def canon_points(a: torch.Tensor) -> torch.Tensor:
    """Rewrite a tensor of Jacobian points (..., 3, 16 int32 limbs) to the
    canonical representative of each group element: affine limbs with
    Z = 1 in Montgomery form, infinity pinned to (1, 1, 0). Idempotent,
    and collapses all projective representations of one element to the
    same bytes. One Fp inversion launch for the whole tensor."""
    x, y, inf = C.normalize(a.reshape(-1, 3, a.shape[-1]))
    x, y = x.to(a.dtype), y.to(a.dtype)
    one = FP.one_mont(a.device).to(a.dtype).expand(x.shape)
    m = inf[..., None]
    out = torch.stack([torch.where(m, one, x), torch.where(m, one, y),
                       torch.where(m, torch.zeros_like(x), one)], dim=-2)
    return out.reshape(a.shape)


def fold_cts(stack: torch.Tensor) -> torch.Tensor:
    """Homomorphic fold of stacked ciphertexts (k, V, 2, 3, 16) into one
    canonical (V, 2, 3, 16) sum: one launch of the reduce kernel (none for
    k = 1), then `canon_points`."""
    acc = stack[0] if stack.shape[0] == 1 else cuda_ops.point_reduce_flat(
        stack.reshape(stack.shape[0], -1, 3, stack.shape[-1])
    ).reshape(stack.shape[1:])
    return canon_points(acc)


__all__ = ["topology_mode", "tree_fanout", "roots", "children", "parent",
           "subtree", "survivor_layout", "depth", "canon_points",
           "fold_cts", "ENV_TOPOLOGY", "ENV_FANOUT"]
