"""Bucket-tile planner for the grid-encoded query ops (min / max /
frequency_count / union / inter).

These five ops encode over the dense value grid [query_min, query_max] —
at the reference's published scale axis (TIFS/maxOpti.py: 1k -> 1M
buckets) the monolithic encoders materialize an O(rows x buckets)
equality mask (`_presence`, frequency_count) and downstream a
(n_dps, buckets, 2, 3, 16) ciphertext array (384 MB at 1M buckets) in
ONE dispatch. The tile planner splits the bucket axis into fixed-size
tiles so every dispatch — encode mask, encryption slab, range-proof
commit chunk — is bounded by the tile, while the concatenated result
stays bit-identical to the monolithic path (the encoders are
element-wise over the grid; the range-proof transcripts are per-value
independent, proofs/range_proof.py module docstring).

Tiles are balanced (never more than `tile` wide, sizes within 1 of each
other). A copy of drynx_tpu/encoding/tiles.py; the port tiles the grid
encoders, the DPs' encryption and the range proofs' commit stage with
it.
"""
from __future__ import annotations

import dataclasses
import os

# Tile width for the bucket-grid axis (the reference's value).
DEFAULT_TILE = 4096

# Grids at or below this many buckets stay monolithic: one dispatch of a
# few thousand lanes beats the per-tile dispatch overhead.
TILE_THRESHOLD = 8192

ENV_TILE = "DRYNX_BUCKET_TILE"


def tile_width() -> int:
    """The configured tile width (env DRYNX_BUCKET_TILE overrides)."""
    try:
        w = int(os.environ.get(ENV_TILE, DEFAULT_TILE))
    except ValueError:
        return DEFAULT_TILE
    return w if w > 0 else DEFAULT_TILE


def auto_tile(n: int) -> int:
    """Tile width to use for an n-wide grid axis: 0 (monolithic) at or
    below TILE_THRESHOLD, the configured tile above it. This is the ONE
    policy point that makes tiling the default at scale."""
    return tile_width() if int(n) > TILE_THRESHOLD else 0


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """Balanced contiguous tiling of an n-wide grid axis.

    tiles are [start, stop) offsets into the axis; every tile is at most
    `tile` wide. peak_mask_elems bounds the largest row-by-grid equality
    mask any single encode dispatch materializes — the quantity the
    65k-bucket acceptance test pins (rows x tile, NOT rows x buckets)."""

    n: int
    tile: int
    tiles: tuple  # ((start, stop), ...)

    @property
    def n_tiles(self) -> int:
        return len(self.tiles)

    @property
    def max_tile_width(self) -> int:
        return max((b - a) for a, b in self.tiles) if self.tiles else 0

    def peak_mask_elems(self, rows: int) -> int:
        """Largest O(rows x grid) mask a tiled encode dispatch builds."""
        return int(rows) * self.max_tile_width

    def covers(self) -> bool:
        """True iff the tiles exactly partition [0, n)."""
        pos = 0
        for a, b in self.tiles:
            if a != pos or b <= a:
                return False
            pos = b
        return pos == self.n


def plan_tiles(n: int, tile: int | None = None) -> TilePlan:
    """Balanced tiling of an n-wide axis into ceil(n / tile) tiles.

    tile=None uses the configured width; tile=0 forces one monolithic
    tile. Balanced (sizes differ by at most 1) so the post-bucketing
    set of slab shapes is minimal."""
    n = int(n)
    if tile is None:
        tile = tile_width()
    if n <= 0:
        return TilePlan(n=n, tile=int(tile), tiles=())
    if tile <= 0 or tile >= n:
        return TilePlan(n=n, tile=int(tile), tiles=((0, n),))
    k = -(-n // int(tile))          # ceil: k tiles, each <= tile wide
    base, extra = divmod(n, k)
    out, start = [], 0
    for i in range(k):
        stop = start + base + (1 if i < extra else 0)
        out.append((start, stop))
        start = stop
    return TilePlan(n=n, tile=int(tile), tiles=tuple(out))


def proof_tile_shards(v: int, tile: int) -> int:
    """Shard count that tiles a V-wide proof value axis at `tile`:
    create_range_proofs runs its commit stage through
    _commit_kernel_sharded with this count, so each per-tile dispatch is
    bounded by the tile. 1 means no tiling."""
    v, tile = int(v), int(tile)
    if tile <= 0 or v <= tile:
        return 1
    return -(-v // tile)


__all__ = ["DEFAULT_TILE", "TILE_THRESHOLD", "ENV_TILE", "TilePlan",
           "plan_tiles", "auto_tile", "tile_width", "proof_tile_shards"]
