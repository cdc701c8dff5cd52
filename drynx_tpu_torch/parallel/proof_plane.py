"""The proof plane: the device-sharding policy of proof creation and of the
joint range check.

The port's counterpart of drynx_tpu/parallel/proof_plane.py. With two or
more CUDA devices visible, the proof pipeline's two flat-batch paths run
sharded by default:

  * creation: each shard of the all-DP digit batch runs the commitment
    stage on its slice (proofs/range_proof.py `_commit_kernel_sharded`),
    and the commitments are gathered once before the Fiat-Shamir hash;
  * verification: each shard runs the RLC check's Miller loops and GT
    powers on its slice of the joint digit batch
    (parallel/proof_mesh.py `rlc_total_shards`), and the partial GT
    products combine by one product.

One process drives every device. Shard i of a batch whose tensors live
on cuda:j runs on `cuda:((j + i) % torch.cuda.device_count())`, so shard 0
runs on the caller's device and the results are gathered back to it; its
kernels are enqueued on that device's current stream (the port's launches
are asynchronous), and `dispatch_shards` synchronizes once at the end. On
one card placement is the identity, a mesh of one, as the reference has
on one device; on CPU tensors it is the identity too. Proofs are independent per value and the
GT arithmetic is exact with canonical residues, so every sharded result
is byte-identical to the single-device one.

The policy: `n_shards()` is the count of visible CUDA devices (1 without
CUDA), so the plane is off on one card. `set_shards(k)` forces a count
for the process (None restores the policy), and the entry points take an
explicit `n_shards=`.
"""
from __future__ import annotations

import time
from typing import Optional

import torch

from ..utils.timers import PhaseTimers

# Batches smaller than this never shard (the reference's value).
MIN_ITEMS_PER_SHARD = 1

# Per-shard spans ("<Phase>.shard<i>", "<Phase>.dispatch.shard<i>") and
# the "<Phase>.<stage>#<host_glue|device_compute>" split keys.
SHARD_TIMERS = PhaseTimers()

_FORCED: Optional[int] = None


def set_shards(k: Optional[int]) -> None:
    """Force the plane's shard count for this process (None: the visible
    CUDA devices again)."""
    global _FORCED
    _FORCED = None if k is None else max(1, int(k))


def device_count() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def n_shards() -> int:
    """The shard count the plane runs at: the forced count, else the
    visible CUDA devices (at least 1)."""
    return _FORCED if _FORCED is not None else max(1, device_count())


def enabled() -> bool:
    """True iff sharded creation and verification are the default path."""
    return n_shards() >= 2


def shard_device(i: int, lead=None) -> torch.device:
    """The device of shard i of a batch led by `lead` (the caller's
    device; None: cuda:0): cuda:((lead + i) mod the visible devices), so
    shard 0 is the lead; a device that is not CUDA leads every shard."""
    lead = torch.device("cuda", 0) if lead is None else torch.device(lead)
    if lead.type != "cuda":
        return lead
    j = lead.index if lead.index is not None else torch.cuda.current_device()
    return torch.device("cuda", (j + i) % max(1, device_count()))


def _tree_map(fn, tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, x) for x in tree)
    return fn(tree)


def _to(x, dev):
    if isinstance(x, torch.Tensor) and x.is_cuda and x.device != dev:
        return x.to(dev, non_blocking=True)
    return x


def put_shard(tree, i: int, lead=None):
    """Place one shard's tensors on shard i's device under `lead`
    (`shard_device`). CUDA tensors already there, and CPU tensors, pass
    through untouched."""
    dev = shard_device(i, lead)
    return _tree_map(lambda x: _to(x, dev), tree)


def gather(tree, lead=None):
    """Bring per-shard results back to the lead device (None: cuda:0)."""
    dev = shard_device(0, lead)
    return _tree_map(lambda x: _to(x, dev), tree)


def shard_slices(n: int, k: int,
                 min_items: int = MIN_ITEMS_PER_SHARD) -> list:
    """Balanced contiguous [start, stop) slices of range(n) over <= k
    shards; never emits an empty shard, never splits below min_items."""
    n, k = int(n), int(k)
    if n <= 0:
        return []
    k = max(1, min(k, n // max(1, min_items)) or 1)
    base, extra = divmod(n, k)
    out, start = [], 0
    for i in range(k):
        stop = start + base + (1 if i < extra else 0)
        out.append((start, stop))
        start = stop
    return out


def record_shard(phase: str, i: int, seconds: float) -> None:
    SHARD_TIMERS.add(f"{phase}.shard{i}", seconds)


def timers_snapshot() -> dict:
    """{"<Phase>.shard<i>": seconds} accumulated in this process, with the
    "<Phase>.<stage>#<host_glue|device_compute>" keys."""
    return {k: round(v, 6) for k, v in SHARD_TIMERS.items()}


def _cuda_devices(tree) -> set:
    if isinstance(tree, (tuple, list)):
        return set().union(*(_cuda_devices(x) for x in tree))
    if isinstance(tree, torch.Tensor) and tree.is_cuda:
        return {tree.device}
    return set()


def _first_device(tree):
    if isinstance(tree, (tuple, list)):
        for x in tree:
            d = _first_device(x)
            if d is not None:
                return d
        return None
    return tree.device if isinstance(tree, torch.Tensor) else None


def dispatch_shards(phase: str, fn, shard_args: list, prefetch=None) -> list:
    """fn(i, *args_i) for every shard, as a pipeline.

    The dispatching thread never waits between shards: shard i+1's inputs
    are staged by ``prefetch(i + 1, *args)`` (placement, slicing) right
    after shard i's kernels are enqueued, and one synchronize of every
    device used waits for the whole batch. With ``prefetch``, ``fn`` gets
    its return value instead of the raw args. The spans: "<Phase>.shard<i>"
    from shard i's dispatch to the barrier's end, "<Phase>.dispatch.shard<i>"
    for the fn() call; the split keys <Phase>.enqueue (host glue on the
    card, where fn only enqueues; device compute on the CPU, where fn runs
    to completion), <Phase>.upload (host glue) and <Phase>.block (device
    compute). Results are gathered to the lead device, the one shard 0's
    result lies on (`put_shard` places shard 0 on its batch's lead)."""
    n = len(shard_args)
    outs, t0s = [], []
    devs = set()
    nxt = prefetch(0, *shard_args[0]) if (prefetch and n) else None
    for i, args in enumerate(shard_args):
        cur = nxt if prefetch else args
        t0 = time.perf_counter()
        t0s.append(t0)
        out = fn(i, *cur)
        dt = time.perf_counter() - t0
        devs |= _cuda_devices(out)
        record_shard(f"{phase}.dispatch", i, dt)
        SHARD_TIMERS.add_split(f"{phase}.enqueue",
                               "host_glue" if devs else "device_compute", dt)
        outs.append(out)
        if prefetch and i + 1 < n:
            tp = time.perf_counter()
            nxt = prefetch(i + 1, *shard_args[i + 1])
            SHARD_TIMERS.add_split(f"{phase}.upload", "host_glue",
                                   time.perf_counter() - tp)
    tb = time.perf_counter()
    # the batch's one barrier, by design
    for d in sorted(devs, key=lambda d: d.index):
        torch.cuda.synchronize(d)  # drynx: noqa[host-sync-in-hot-path]
    tend = time.perf_counter()
    SHARD_TIMERS.add_split(f"{phase}.block", "device_compute", tend - tb)
    for i in range(n):
        record_shard(phase, i, tend - t0s[i])
    lead = _first_device(outs[0]) if n else None
    return [gather(o, lead) for o in outs]


__all__ = ["enabled", "n_shards", "set_shards", "device_count",
           "shard_device", "shard_slices", "put_shard", "gather",
           "dispatch_shards", "record_shard", "timers_snapshot",
           "SHARD_TIMERS", "MIN_ITEMS_PER_SHARD"]
