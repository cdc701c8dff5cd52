"""Query-operation encoders: local data -> sufficient-statistics vectors
(the port's counterpart of drynx_tpu/encoding)."""
from . import tiles  # noqa: F401
from .stats import (  # noqa: F401
    GRID_OPS,
    OPS,
    DecryptedVector,
    decode,
    encode_clear,
    encode_clear_tiled,
    encode_clear_tiles,
    output_size,
)
