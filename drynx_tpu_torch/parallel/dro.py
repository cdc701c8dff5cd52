"""Differential privacy: quantized Laplace noise + distributed results
obfuscation (DRO) via re-randomized shuffling.

The port's counterpart of drynx_tpu/parallel/dro.py (reference semantics,
SURVEY.md §2.2): the DRO phase builds a list of encrypted, quantized
Laplace noise values; servers shuffle + re-randomize the list so no one
knows which noise value lands on which result; one noise ciphertext is
added per result at the key-switch root (reference
services/service.go:600-604, 619-665).

The noise list is DETERMINISTIC (privacy comes from the secret shuffle, not
from sampling): quantized values 0, ±q, ±2q, ... are repeated proportionally
to the Laplace(mean, b) density until `size` values exist. Its host
construction is the reference's, and gives the same int64 list.

Each server applies a secret permutation (`torch.randperm` on an explicit
generator) and re-randomizes every ciphertext by adding a fresh encryption
of zero (r·B, r·P): two launches of the fixed-base kernel, then one of the
batched add over both components. The shuffle proof lives in
proofs/shuffle.py.

Above CHUNK elements the precompute and the re-randomization run in
CHUNK-wide slabs dispatched over the proof plane's shards
(`proof_plane.dispatch_shards`: with the plane enabled slab i runs on
`shard_device(i, <the caller's device>)`, else every slab on the caller's
device, one after another; the slabs come back to the caller's device).
The permutation is drawn once and every per-element step
is element-wise, so chunked output equals unchunked output byte for byte.

API convention: `FixedBase` objects stop at the encryption boundary
(encrypt_noise, dro_pipeline); the shuffle/precompute layer takes raw
(64, 16, 3, 16) limb tables (`FixedBase.table`) and refuses the wrapper.
Randomness comes from a `torch.Generator`, or is given as draws.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..crypto import elgamal as eg
from ..resilience.policy import named_lock
from ..utils.device import resolve

# Slab width for chunked precompute / shuffle re-randomization (the
# reference's, crypto/batching.py max_bucket).
CHUNK = 4096


def _noise_reps(vs: np.ndarray, mean: float, b: float, quanta: float,
                size: int) -> np.ndarray:
    """Vectorized per-value repetition counts of the density grid.

    np.round matches Python round() (both half-to-even) and np.exp is the
    same libm exp() the scalar loop called."""
    dens = np.exp(-np.abs(vs - mean) / b)
    return np.maximum(
        1, np.round(dens * size * quanta / (2.0 * b)).astype(np.int64))


def generate_noise_values(size: int, mean: float, b: float, quanta: float,
                          scale: float = 1.0, limit: float = 0.0) -> np.ndarray:
    """Deterministic quantized-Laplace noise list (int64, scaled).

    Mirrors unlynx GenerateNoiseValuesScale as used at reference
    services/service.go:657: values v = mean ± k*quanta, each repeated
    proportionally to exp(-|v-mean|/b); `scale` multiplies values before
    int64 quantization; `limit` (if nonzero) truncates |v| <= limit.
    Vectorized as a NumPy density grid; the output is exactly
    `_generate_noise_values_ref`'s."""
    if size <= 0:
        return np.zeros((0,), dtype=np.int64)
    total = 0
    vals = np.zeros((0,), dtype=np.float64)
    k_lo, k_hi = 0, 0
    grow = max(64, int(math.isqrt(size)))
    while total < size and k_lo <= 10 * size:
        k_hi = min(k_lo + grow, 10 * size + 1)
        ks = np.arange(k_lo, k_hi, dtype=np.int64)
        # candidate order within the loop: [m] then (m+kq, m-kq) pairs
        vs = np.empty(2 * ks.size, dtype=np.float64)
        vs[0::2] = mean + ks * quanta
        vs[1::2] = mean - ks * quanta
        if k_lo == 0:
            vs = np.concatenate([vs[:1], vs[2:]])  # k=0 contributes once
        if limit:
            vs = vs[np.abs(vs) <= limit]
        if vs.size:
            reps = _noise_reps(vs, mean, b, quanta, size)
            cum = np.cumsum(reps)
            cut = int(np.searchsorted(cum, size - total))
            if cut < vs.size:  # target reached inside this block
                vals = np.concatenate(
                    [vals, np.repeat(vs[:cut + 1], reps[:cut + 1])])
                total += int(cum[cut])
                break
            vals = np.concatenate([vals, np.repeat(vs, reps)])
            total += int(cum[-1])
        k_lo = k_hi
        grow *= 2
    out = vals[:size] * scale
    return np.round(out).astype(np.int64)


def _generate_noise_values_ref(size: int, mean: float, b: float,
                               quanta: float, scale: float = 1.0,
                               limit: float = 0.0) -> np.ndarray:
    """The interpreted accumulation, kept as the golden reference for the
    vectorized construction (unit-test only)."""
    if size <= 0:
        return np.zeros((0,), dtype=np.int64)
    vals: list[float] = []
    k = 0
    while len(vals) < size:
        for v in ([mean] if k == 0 else [mean + k * quanta, mean - k * quanta]):
            if limit and abs(v) > limit:
                continue
            dens = math.exp(-abs(v - mean) / b)
            rep = max(1, int(round(dens * size * quanta / (2.0 * b))))
            vals.extend([v] * rep)
            if len(vals) >= size:
                break
        k += 1
        if k > 10 * size:  # safety for degenerate params
            break
    out = np.asarray(vals[:size], dtype=np.float64) * scale
    return np.round(out).astype(np.int64)


def _require_table(tbl, who: str):
    """The shuffle/precompute layer's convention: raw limb tables only."""
    if isinstance(tbl, eg.FixedBase):
        raise TypeError(
            f"{who} takes a raw fixed-base table (FixedBase.table), got a "
            f"FixedBase wrapper — unwrap it at the encryption boundary")
    return tbl


def _draw_scalars(size: int, generator, device) -> torch.Tensor:
    if generator is None:
        raise ValueError("DRO randomness needs a generator or draws")
    return eg.random_scalars((size,), generator, device)


def encrypt_noise(pub_table: eg.FixedBase, noise, generator=None, r=None,
                  base_tbl=None):
    """Encrypt the noise list under the collective key, on the device of
    `pub_table.table`, with blinding scalars `r` (S, 16) or drawn from
    `generator`. Negative values encrypt as n - |v|."""
    if not isinstance(pub_table, eg.FixedBase):
        raise TypeError("encrypt_noise takes the FixedBase wrapper "
                        "(the encryption boundary); got a raw table")
    dev = pub_table.table.device
    # the noise values are a host list: one upload, not a round trip
    values = torch.as_tensor(  # drynx: noqa[host-roundtrip-in-decode]
        np.asarray(noise, dtype=np.int64),  # drynx: noqa[host-sync-in-hot-path]
        device=dev)
    if r is None:
        r = _draw_scalars(values.shape[0], generator, dev)
    base_tbl = (base_tbl if base_tbl is not None
                else eg.BASE_TABLE.table.to(dev))
    return eg.encrypt_ints_with_tables(base_tbl, pub_table.table, values,
                                       r.to(dev))


def _chunk_of(size: int, chunk: int | None) -> int:
    """Effective slab width: None = auto (CHUNK above CHUNK elements),
    0 = force unchunked, positive = forced width."""
    if chunk is None:
        return CHUNK if size > CHUNK else 0
    return int(chunk)


def _slabs(size: int, chunk) -> list[tuple[int, int]]:
    eff = _chunk_of(size, chunk)
    if not eff or eff >= size:
        return [(0, size)]
    return [(a, min(a + eff, size)) for a in range(0, size, eff)]


def slab_widths(size: int, chunk: int | None = None) -> list[int]:
    """Distinct widths the chunked DRO path uses at ``size`` (at most two:
    the slab width and a remainder)."""
    if size <= 0:
        return []
    return sorted({b - a for a, b in _slabs(size, chunk)})


# Fresh-precompute counter: increments on every FRESH precompute (the
# expensive fixed-base pass a warm pool exists to skip). The pool tests
# assert it stays flat when a warm pool or prewarmed entries serve a
# survey. Proof threads and refills can precompute concurrently, so it is
# bumped under a lock.
PRECOMPUTE_CALLS = 0
_PRECOMPUTE_COUNT_LOCK = named_lock("precompute_count_lock")


def _zeros(r, pub_tbl, base_tbl):
    return torch.stack([eg.fixed_base_mul(base_tbl.to(r.device), r),
                        eg.fixed_base_mul(pub_tbl.to(r.device), r)], dim=-3)


def _encrypt_zeros(r, pub_tbl, base_tbl, chunk, phase: str):
    """Fresh zero-encryptions (r·B, r·P) for blinding scalars r (S, 16):
    per slab, one fixed-base launch on each table, the slabs dispatched
    over the proof plane under `phase`."""
    from . import proof_plane as plane

    slabs = _slabs(int(r.shape[0]), chunk)
    if len(slabs) == 1:
        return _zeros(r, pub_tbl, base_tbl)
    spread = plane.enabled()
    parts = plane.dispatch_shards(
        phase, lambda i, rs: _zeros(rs, pub_tbl, base_tbl), slabs,
        prefetch=lambda i, a, b: (
            plane.put_shard(r[a:b], i, r.device) if spread else r[a:b],))
    return torch.cat(parts)


def precompute_rerandomization(pub_tbl, size: int, generator=None,
                               base_tbl=None, chunk: int | None = None,
                               r=None):
    """Precompute the expensive half of a shuffle step: `size` fresh
    encryptions of zero (r·B, r·P) plus their scalars, on the device of
    `pub_tbl`.

    The reference caches exactly this per server across surveys
    (`pre_compute_multiplications.gob`, services/service.go:34,316-317).
    Returns (zero_cts (S, 2, 3, 16), r (S, 16)) usable as the `precomp`
    argument of shuffle_rerandomize. The scalars r are drawn in one call
    (or given), so chunking never changes them."""
    global PRECOMPUTE_CALLS

    _require_table(pub_tbl, "precompute_rerandomization")
    with _PRECOMPUTE_COUNT_LOCK:
        PRECOMPUTE_CALLS += 1
    dev = pub_tbl.device
    base_tbl = base_tbl if base_tbl is not None else eg.BASE_TABLE.table.to(dev)
    r = _draw_scalars(size, generator, dev) if r is None else r.to(dev)
    return _encrypt_zeros(r, pub_tbl, base_tbl, chunk, "DROPrecompute"), r


def save_precompute(path: str, precomp) -> None:
    """Persist a precomputation with the reference's `.npz` members
    (zero_ct, r as host uint32)."""
    zero_ct, r = precomp
    np.savez(path, zero_ct=zero_ct.cpu().numpy().astype(np.uint32),
             r=r.cpu().numpy().astype(np.uint32))


def load_precompute(path: str, device=None):
    """A persisted precomputation (either package's) as int32 tensors on
    `device` (the card unless the CPU is named)."""
    dev = resolve(device)
    with np.load(path) as d:
        return to_device(d["zero_ct"], d["r"], dev)


def to_device(zero_ct, r, device):
    """Host (uint32) slab arrays -> int32 tensors on `device`, moved once."""
    # the slabs are host arrays read from the pool's files: one upload
    return (torch.from_numpy(  # drynx: noqa[host-roundtrip-in-decode]
        np.asarray(zero_ct).astype(np.int32)  # drynx: noqa[host-sync-in-hot-path]
    ).to(device), torch.from_numpy(  # drynx: noqa[host-roundtrip-in-decode]
        np.asarray(r).astype(np.int32)  # drynx: noqa[host-sync-in-hot-path]
    ).to(device))


def shuffle_rerandomize(cts, pub_tbl, generator=None, base_tbl=None,
                        precomp=None, chunk: int | None = None, perm=None,
                        r=None):
    """One server's DRO step: secret permutation + re-randomization.

    cts: (S, 2, 3, 16). Returns (shuffled cts, permutation, rerand
    scalars), where out[j] = cts[perm[j]] + (r[j]·B, r[j]·P); the latter
    two feed the shuffle proof. The permutation is `perm` or drawn from
    `generator` first; the scalars come from `precomp` (from
    precompute_rerandomization, which skips the 2S fixed-base products),
    else `r`, else `generator`.

    chunk (None = auto above CHUNK, 0 = force monolithic): gather and
    re-randomize in `chunk`-wide slabs over the proof plane. The permutation
    and scalars are the same either way and ct_add is element-wise, so
    chunked output equals unchunked output byte for byte."""
    _require_table(pub_tbl, "shuffle_rerandomize")
    S = int(cts.shape[0])
    dev = cts.device
    if perm is None:
        if generator is None:
            raise ValueError("DRO randomness needs a generator or draws")
        perm = torch.randperm(S, generator=generator,
                              device=generator.device)
    perm = torch.as_tensor(perm, dtype=torch.int64).to(dev)
    if precomp is not None:
        zero_ct, r = precomp
        assert zero_ct.shape[0] == S, (zero_ct.shape, S)
    else:
        base_tbl = (base_tbl if base_tbl is not None
                    else eg.BASE_TABLE.table.to(dev))
        r = _draw_scalars(S, generator, dev) if r is None else r.to(dev)
        zero_ct = _encrypt_zeros(r, pub_tbl, base_tbl, chunk, "DRORerand")
    slabs = _slabs(S, chunk)
    if len(slabs) == 1:
        return eg.ct_add(cts[perm], zero_ct), perm, r
    from . import proof_plane as plane

    # the exact global permutation: each slab gathers its own indices
    spread = plane.enabled()
    parts = plane.dispatch_shards(
        "DROShuffle", lambda i, g, zc: eg.ct_add(g, zc), slabs,
        prefetch=lambda i, a, b: plane.put_shard(
            (cts[perm[a:b]], zero_ct[a:b]), i, dev) if spread
        else (cts[perm[a:b]], zero_ct[a:b]))
    return torch.cat(parts), perm, r


def dro_pipeline(pub_tbl: eg.FixedBase, size: int, mean: float, b: float,
                 quanta: float, scale: float = 1.0, limit: float = 0.0,
                 n_servers: int = 3, chunk: int | None = None, pool=None,
                 generator=None):
    """Full noise phase: generate, encrypt, pass through every server's
    shuffle+rerandomize, on the device of `pub_tbl.table`. Returns (the
    final encrypted noise list, the clear noise list).

    ``pool`` (a pool.CryptoPool): each server pass first tries to consume
    ``size`` precomputed zero-encryptions keyed by this public table's
    digest, moved to the device once; a short pool falls back to fresh
    precompute for THAT pass only. The generator draws the noise's
    scalars, then per server the permutation and fresh scalars whether or
    not a slab is consumed, so the draws do not depend on the pool."""
    if not isinstance(pub_tbl, eg.FixedBase):
        raise TypeError("dro_pipeline takes the FixedBase wrapper; pass "
                        "pub_tbl.table only to the shuffle layer")
    if generator is None:
        raise ValueError("DRO randomness needs a generator")
    dev = pub_tbl.table.device
    base_tbl = eg.BASE_TABLE.table.to(dev)
    noise = generate_noise_values(size, mean, b, quanta, scale, limit)
    cts = encrypt_noise(pub_tbl, noise, generator, base_tbl=base_tbl)
    digest = None
    if pool is not None:
        from ..pool import store as _ps

        digest = _ps.key_digest(pub_tbl.table)
    S = int(cts.shape[0])
    for _ in range(n_servers):
        perm = torch.randperm(S, generator=generator,
                              device=generator.device)
        r = _draw_scalars(S, generator, dev)
        pc = None
        if pool is not None:
            got = pool.try_consume_dro(digest, S)
            if got is not None:
                pc = to_device(got[0], got[1], dev)
        cts, _, _ = shuffle_rerandomize(cts, pub_tbl.table,
                                        base_tbl=base_tbl, precomp=pc,
                                        chunk=chunk, perm=perm, r=r)
    return cts, noise


__all__ = ["generate_noise_values", "encrypt_noise", "shuffle_rerandomize",
           "precompute_rerandomization", "save_precompute", "load_precompute",
           "to_device", "dro_pipeline", "slab_widths", "CHUNK"]
