"""Sufficient-statistics encoders and decoders of the statistical query ops.

The port's counterpart of drynx_tpu/encoding/stats.py (its ungrouped half),
with the same vectors and the same decoded results:

  sum        [sum x]                               mean      [sum x, N]
  variance   [sum x, N, sum x^2]                   cosim     [sum a, sum b,
                                                    sum a^2, sum b^2, sum ab]
  bool_OR    [bit]   (zero iff false)              bool_AND  [1 - bit]
  min        OR-bits  b_i = (i >= local_min)       max       AND-bits
  frequency_count  histogram over [min, max]
  union      OR presence bits over [min, max]      inter     AND presence bits
  lin_reg    [N, sum Xj, sum XjXk (upper), sum Y, sum XjY]
  r2         [N, sum Y, sum Y^2, sum (pred - y)^2]

AND-semantics ops encode the complement bit, so the homomorphic sum is zero
iff every DP's bit is one. A DP's encoding is an int64 CPU tensor whose
length depends only on the query. Grid ops above `tiles.TILE_THRESHOLD`
buckets encode tile by tile, with the same result. Decoding reads a
`DecryptedVector` (integers where the discrete log resolved, zero flags
always).

Group-by: the group is a leading axis. The group grid (the cartesian
product of each attribute's candidate values) is known from the query, so
one (n_groups, rows) membership mask gives every group's statistics in one
pass, and the homomorphic sum along the aligned group axis is the per-group
aggregation. The querier decodes the group-major vector group by group.
"""
from __future__ import annotations

import dataclasses
from fractions import Fraction

import numpy as np
import torch

from . import tiles

# The five ops that encode over the dense [query_min, query_max] value grid.
GRID_OPS = ("min", "max", "frequency_count", "union", "inter")


def grid_buckets(query) -> int:
    """Bucket-grid width of a grid-op query, 0 for every other op (and for
    a query without an operation)."""
    op = getattr(query, "operation", None)
    if op is None or op.name not in GRID_OPS:
        return 0
    return int(op.query_max) - int(op.query_min) + 1


@dataclasses.dataclass
class DecryptedVector:
    """Decrypted query result: ints where resolvable + zero-flags always."""

    values: np.ndarray   # int64 (nbr_output,) — valid where `found`
    found: np.ndarray    # bool  (nbr_output,)
    is_zero: np.ndarray  # bool  (nbr_output,)


# ---------------------------------------------------------------------------
# Output sizing (reference lib/structs.go:591-641 ChooseOperation)
# ---------------------------------------------------------------------------

def output_size(op: str, query_min: int = 0, query_max: int = 0,
                dims: int = 1) -> int:
    rng = query_max - query_min + 1
    return {
        "sum": 1,
        "mean": 2,
        "variance": 3,
        "cosim": 5,
        "bool_OR": 1,
        "bool_AND": 1,
        "min": rng,
        "max": rng,
        "frequency_count": rng,
        "union": rng,
        "inter": rng,
        "lin_reg": (dims * dims + 5 * dims + 4) // 2,
        "r2": 4,
    }[op]


# ---------------------------------------------------------------------------
# Clear-text local encoders (int64 in and out, on the CPU)
# ---------------------------------------------------------------------------

def _i64(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.int64))


def _grid(lo: int, hi: int) -> torch.Tensor:
    return torch.arange(lo, hi, dtype=torch.int64)


def _scale(bit_scale) -> torch.Tensor:
    return torch.tensor(1 if bit_scale is None else int(bit_scale),
                        dtype=torch.int64)


def _grid_tile(op: str, x, local, grid, s) -> torch.Tensor:
    """One slab of a grid op's encoding over the values `grid`."""
    if op == "min":
        return (grid >= local).to(torch.int64) * s
    if op == "max":
        return (1 - (grid >= local).to(torch.int64)) * s
    eq = x[:, None] == grid[None, :]
    if op == "frequency_count":
        return eq.sum(0).to(torch.int64)
    present = eq.any(0).to(torch.int64)
    return present * s if op == "union" else (1 - present) * s


def encode_clear_tiles(op: str, data, query_min: int = 0, query_max: int = 0,
                       tile: int | None = None, bit_scale=None):
    """Per-tile grid encodings: yields (offset, enc_tile) pairs covering
    [query_min, query_max] in plan_tiles order; each builds at most an
    O(rows x tile) equality mask."""
    if op not in GRID_OPS:
        raise ValueError(f"not a grid op: {op!r}")
    x = _i64(data)
    s = _scale(bit_scale)
    plan = tiles.plan_tiles(query_max - query_min + 1, tile)
    local = x.min() if op == "min" else x.max() if op == "max" else None
    for a, b in plan.tiles:
        yield a, _grid_tile(op, x, local,
                            _grid(query_min + a, query_min + b), s)


def encode_clear_tiled(op: str, data, query_min: int = 0, query_max: int = 0,
                       tile: int | None = None, bit_scale=None):
    """Tiled grid-op encoding, concatenated: the same vector as
    `encode_clear`."""
    return torch.cat([enc for _, enc in encode_clear_tiles(
        op, data, query_min, query_max, tile, bit_scale)])


def encode_clear(op: str, data, query_min: int = 0, query_max: int = 0,
                 preds=None, bit_scale=None) -> torch.Tensor:
    """Local sufficient statistics for one DP. `data`: int64 (rows,) or
    (rows, cols) for cosim (2 cols) / lin_reg (d features + label last).
    `preds`: model predictions for r2. `bit_scale`: optional random nonzero
    int64 multiplier for OR/AND-family encodings (non-proof mode)."""
    if op in GRID_OPS:
        t = tiles.auto_tile(query_max - query_min + 1)
        if t:
            return encode_clear_tiled(op, data, query_min, query_max, t,
                                      bit_scale)
        x = _i64(data)
        local = x.min() if op == "min" else x.max() if op == "max" else None
        return _grid_tile(op, x, local, _grid(query_min, query_max + 1),
                          _scale(bit_scale))
    x = _i64(data)
    s = _scale(bit_scale)
    n = torch.tensor(x.shape[0], dtype=torch.int64)
    if op == "sum":
        return x.sum()[None]
    if op == "mean":
        return torch.stack([x.sum(), n])
    if op == "variance":
        return torch.stack([x.sum(), n, (x * x).sum()])
    if op == "cosim":
        a, b = x[:, 0], x[:, 1]
        return torch.stack([a.sum(), b.sum(), (a * a).sum(), (b * b).sum(),
                            (a * b).sum()])
    if op == "bool_OR":
        return ((x != 0).any().to(torch.int64) * s)[None]
    if op == "bool_AND":
        return ((1 - (x != 0).all().to(torch.int64)) * s)[None]
    if op == "lin_reg":
        X, y = x[:, :-1], x[:, -1]
        iu, ju = np.triu_indices(X.shape[1])
        sxx = (X.T @ X)[torch.from_numpy(iu), torch.from_numpy(ju)]
        return torch.cat([n[None], X.sum(0), sxx, y.sum()[None], X.T @ y])
    if op == "r2":
        err = _i64(preds) - x
        return torch.stack([n, x.sum(), (x * x).sum(), (err * err).sum()])
    raise ValueError(f"unknown operation {op!r}")


# ---------------------------------------------------------------------------
# Group-by encoders (reference data_collection_protocol.go:157-196)
# ---------------------------------------------------------------------------

def group_grid(group_by) -> np.ndarray:
    """Cartesian product of candidate values per group attribute
    (reference AllPossibleGroups): [[vals_attr0], [vals_attr1], ...]
    -> int64 (n_groups, n_attrs), the first attribute slowest."""
    arrs = [np.asarray(v, dtype=np.int64) for v in group_by]
    mesh = np.meshgrid(*arrs, indexing="ij")
    return np.stack([m.ravel() for m in mesh], axis=-1)


def encode_clear_grouped(op: str, data, groups, grid, query_min: int = 0,
                         query_max: int = 0, preds=None,
                         bit_scale=None) -> torch.Tensor:
    """Per-group local sufficient statistics, int64 (n_groups, V).

    data: as encode_clear. groups: (rows, n_attrs) group label per record.
    grid: (n_groups, n_attrs) from group_grid(). An empty group encodes the
    operation's identity (zero sums, empty-set bits)."""
    x = _i64(data)
    g, gr = _i64(groups), _i64(grid)
    s = _scale(bit_scale)
    mask = (g[None, :, :] == gr[:, None, :]).all(-1)     # (n_groups, rows)
    mi = mask.to(torch.int64)
    n = mi.sum(1)
    if op == "sum":
        return (mi @ x)[:, None]
    if op == "mean":
        return torch.stack([mi @ x, n], 1)
    if op == "variance":
        return torch.stack([mi @ x, n, mi @ (x * x)], 1)
    if op == "cosim":
        a, b = x[:, 0], x[:, 1]
        return torch.stack([mi @ a, mi @ b, mi @ (a * a), mi @ (b * b),
                            mi @ (a * b)], 1)
    if op == "bool_OR":
        return ((mask & (x != 0)[None]).any(1).to(torch.int64) * s)[:, None]
    if op == "bool_AND":
        # an empty group is an AND over the empty set: true, encoded 0
        bit = torch.where(mask, (x != 0)[None], True).all(1)
        return ((1 - bit.to(torch.int64)) * s)[:, None]
    grid_v = _grid(query_min, query_max + 1)
    if op == "min":
        # empty-group sentinel max + 1: every bit 0, nothing for the OR
        local = torch.where(mask, x[None], query_max + 1).min(1).values
        return (grid_v[None] >= local[:, None]).to(torch.int64) * s
    if op == "max":
        # empty-group sentinel min - 1: every bit 1, complement 0
        local = torch.where(mask, x[None], query_min - 1).max(1).values
        return (1 - (grid_v[None] >= local[:, None]).to(torch.int64)) * s
    if op in ("frequency_count", "union", "inter"):
        eq = (x[:, None] == grid_v[None]).to(torch.int64)   # (rows, V)
        counts = mi @ eq
        if op == "frequency_count":
            return counts
        present = (counts > 0).to(torch.int64)
        return present * s if op == "union" else (1 - present) * s
    if op == "lin_reg":
        X, y = x[:, :-1], x[:, -1]
        iu, ju = np.triu_indices(X.shape[1])
        outer = torch.einsum("gr,rd,re->gde", mi, X, X)
        sxx = outer[:, torch.from_numpy(iu), torch.from_numpy(ju)]
        return torch.cat([n[:, None], mi @ X, sxx, (mi @ y)[:, None],
                          torch.einsum("gr,r,rd->gd", mi, y, X)], 1)
    if op == "r2":
        err = _i64(preds) - x
        return torch.stack([n, mi @ x, mi @ (x * x), mi @ (err * err)], 1)
    raise ValueError(f"unknown operation {op!r} for grouped encoding")


def decode_grouped(op: str, dec: DecryptedVector, grid, query_min: int = 0,
                   query_max: int = 0, dims: int = 1) -> dict:
    """Per-group decode (reference services/api.go:124-128) of the
    group-major (n_groups * V,) vector: {group tuple: result}.

    An empty group decodes to None where the op can say so: mean,
    variance, cosim, r2 and lin_reg carry an N (cosim a zero norm), min's
    bits are all zero, and the order statistics of an empty histogram are
    None (top_k: []). `max` cannot: its complement encoding's neutral
    element equals a genuine max of query_min, so an empty group decodes
    to query_min, the same ambiguity as the reference's bit encoding
    (min_max.go:87-123)."""
    grid = np.asarray(grid)
    n_groups = grid.shape[0]
    v = np.asarray(dec.values).reshape(n_groups, -1)
    f = np.asarray(dec.found).reshape(n_groups, -1)
    z = np.asarray(dec.is_zero).reshape(n_groups, -1)
    out = {}
    for gi in range(n_groups):
        key = tuple(int(t) for t in grid[gi])
        if op == "cosim" and int(v[gi][2]) * int(v[gi][3]) == 0:
            out[key] = None
            continue
        sub = DecryptedVector(values=v[gi], found=f[gi], is_zero=z[gi])
        try:
            out[key] = decode(op, sub, query_min, query_max, dims)
        except ZeroDivisionError:
            out[key] = None   # empty group: mean, variance, r2 undefined
    return out


# ---------------------------------------------------------------------------
# Decoders (host-side; exact rational arithmetic where the reference is exact)
# ---------------------------------------------------------------------------

def _first_nonzero(flags_nonzero, lo: int):
    idx = np.flatnonzero(flags_nonzero)
    return None if idx.size == 0 else lo + int(idx[0])


def decode(op: str, dec: DecryptedVector, query_min: int = 0,
           query_max: int = 0, dims: int = 1):
    v = np.asarray(dec.values, dtype=np.int64)
    nz = ~np.asarray(dec.is_zero)

    if op == "sum":
        return int(v[0])
    if op == "mean":
        return float(v[0]) / float(v[1])
    if op == "variance":
        s, n, ss = (int(v[0]), int(v[1]), int(v[2]))
        mean = s / n
        return ss / n - mean * mean
    if op == "cosim":
        sa, sb, saa, sbb, sab = (int(t) for t in v)
        return sab / (np.sqrt(saa) * np.sqrt(sbb))
    if op == "bool_OR":
        return bool(nz[0])
    if op == "bool_AND":
        return not bool(nz[0])
    if op == "min":
        return _first_nonzero(nz, query_min)
    if op == "max":
        # encoded complement: aggregated zero at i iff every DP max <= i
        return _first_nonzero(~nz, query_min)
    if op == "frequency_count":
        return {query_min + i: int(c) for i, c in enumerate(v)}
    if op == "union":
        return [query_min + i for i in np.flatnonzero(nz)]
    if op == "inter":
        return [query_min + i for i in np.flatnonzero(~nz)]
    base, _, arg = op.partition(":")
    if base in DECODE_MODES:
        return _decode_histogram_mode(base, arg, v, query_min)
    if op == "lin_reg":
        return _decode_linreg(v, dims)
    if op == "r2":
        n, sy, syy, serr = (int(t) for t in v)
        denom = Fraction(syy) - Fraction(sy * sy, n)
        if denom == 0:
            return 0.0
        return float(1 - Fraction(serr) / denom)
    raise ValueError(f"unknown operation {op!r}")


def _decode_linreg(v: np.ndarray, d: int):
    """Solve the normal equations exactly (rational Gaussian elimination,
    mirroring reference linear_regression_dims.go:110-204)."""
    n = int(v[0])
    sx = [int(t) for t in v[1:1 + d]]
    ntri = d * (d + 1) // 2
    sxx_flat = [int(t) for t in v[1 + d:1 + d + ntri]]
    sy = int(v[1 + d + ntri])
    sxy = [int(t) for t in v[2 + d + ntri:2 + 2 * d + ntri]]

    sxx = [[0] * d for _ in range(d)]
    k = 0
    for i in range(d):
        for j in range(i, d):
            sxx[i][j] = sxx[j][i] = sxx_flat[k]
            k += 1

    # Augmented (d+1)x(d+2) system for [b0, b1..bd]
    A = [[Fraction(0)] * (d + 2) for _ in range(d + 1)]
    A[0][0] = Fraction(n)
    for j in range(d):
        A[0][j + 1] = A[j + 1][0] = Fraction(sx[j])
    for i in range(d):
        for j in range(d):
            A[i + 1][j + 1] = Fraction(sxx[i][j])
    A[0][d + 1] = Fraction(sy)
    for i in range(d):
        A[i + 1][d + 1] = Fraction(sxy[i])

    m = d + 1
    for col in range(m):
        piv = next((r for r in range(col, m) if A[r][col] != 0), None)
        if piv is None:
            return None  # singular system
        A[col], A[piv] = A[piv], A[col]
        pv = A[col][col]
        A[col] = [a / pv for a in A[col]]
        for r in range(m):
            if r != col and A[r][col] != 0:
                f = A[r][col]
                A[r] = [a - f * b for a, b in zip(A[r], A[col])]
    return np.asarray([float(A[r][m]) for r in range(m)])


def _decode_histogram_mode(mode: str, arg: str, counts: np.ndarray,
                           query_min: int):
    """Order statistics over a ``frequency_count`` histogram: ``"median"``,
    ``"quantile:q"`` (bare: the median) and ``"top_k:k"`` (bare: k = 1).
    An all-zero histogram has no q-th value (None) and no top values ([]).
    """
    c = counts.astype(np.int64)
    total = int(c.sum())
    if mode == "top_k":
        k = int(arg) if arg else 1
        if k <= 0:
            raise ValueError(f"top_k needs a positive k, got {k}")
        idx = np.flatnonzero(c > 0)
        # count desc, then grid value asc: a deterministic total order
        order = sorted(idx, key=lambda i: (-int(c[i]), int(i)))
        return [query_min + int(i) for i in order[:k]]
    q = 0.5 if mode == "median" else (float(arg) if arg else 0.5)
    if not 0.0 < q <= 1.0:
        raise ValueError(f"quantile q must be in (0, 1], got {q}")
    if total == 0:
        return None
    # lower quantile (inverse CDF): smallest grid value whose cumulative
    # count reaches rank ceil(q * total); q=0.5 is the lower median
    rank = int(np.ceil(q * total))
    cum = np.cumsum(c)
    return query_min + int(np.searchsorted(cum, rank))


OPS = ["sum", "mean", "variance", "cosim", "bool_OR", "bool_AND", "min",
       "max", "frequency_count", "union", "inter", "lin_reg", "r2"]

# Decode-only modes: they read a frequency_count vector.
DECODE_MODES = ("quantile", "median", "top_k")

__all__ = ["OPS", "GRID_OPS", "DECODE_MODES",
           "DecryptedVector", "encode_clear", "decode", "output_size",
           "encode_clear_tiles", "encode_clear_tiled", "grid_buckets",
           "group_grid", "encode_clear_grouped", "decode_grouped"]
