"""Position hashing and hash-group ranking.

The reference builds zlib-style ``head``/``prev`` chains by inserting positions
one at a time (chained_hash_table.rs:118-158).  The data-parallel formulation computes
the same neighborhood structure wholesale: hash every position, then stable
sort positions by hash.  Within the sorted order, the ``k`` entries preceding a
position with the same hash are exactly the ``k`` most recent earlier positions
with that hash — i.e. the first ``k`` links of the reference's hash chain —
because stable sorting preserves position order inside each hash bucket.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..constants import HASH_MASK

# Sort key reserved for positions that cannot start a match (fewer than 3 bytes
# of real data).  Larger than any real hash, so invalid positions cluster at
# the end of the sorted order and never interleave with real buckets.
INVALID_KEY = HASH_MASK + 1


def hash3(data_padded, n_positions: int):
    """Rolling 3-byte hash at every position, reference-compatible.

    h(i) = ((d[i] << 10) ^ (d[i+1] << 5) ^ d[i+2]) & 0x7FFF  — the closed form
    of the reference's rolling update h = ((h << 5) ^ b) & 0x7FFF over a 3-byte
    window (chained_hash_table.rs:55-62).

    Args:
      data_padded: uint8[>= n_positions + 2].
      n_positions: static number of positions to hash.

    Returns:
      int32[n_positions] hash values in [0, 0x8000).
    """
    d = data_padded.astype(jnp.int32)
    h = (d[:n_positions] << 10) ^ (d[1 : n_positions + 1] << 5) ^ d[2 : n_positions + 2]
    return h & HASH_MASK
