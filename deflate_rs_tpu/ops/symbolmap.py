"""Arithmetic length/distance code mapping (gather-free).

The reference maps lengths/distances to codes via lookup tables
(LENGTH_CODE / DISTANCE_CODES, huffman_table.rs:50-126).  Both mappings are
pure bit arithmetic on the value, so no table gather is needed:
DEFLATE code ranges are power-of-two buckets, so the code index is a function
of the value's bit length, recovered exactly from the float32 exponent
(values < 2**24 are exactly representable).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def bitlen(x):
    """Number of significant bits of x (x in [1, 2**24))."""
    f = x.astype(jnp.float32)
    return (jax.lax.bitcast_convert_type(f, jnp.int32) >> 23) - 126


def length_code(length):
    """(code 0..28, extra_bits, extra_value) for match length 3..258.

    Symbol = 257 + code. Matches LENGTH_TO_CODE/LENGTH_BASE/LENGTH_EXTRA_BITS.
    """
    l = length - 3
    lc = jnp.maximum(l, 1)
    e = jnp.maximum(bitlen(lc) - 3, 0)
    small = l < 8
    is258 = length >= 258
    code = jnp.where(small, l, (e << 2) + (lc >> e))
    code = jnp.where(is258, 28, code)
    extra_n = jnp.where(small | is258, 0, e)
    base = jnp.where(small | is258, length, ((4 + (code & 3)) << e) + 3)
    return code, extra_n, length - base


def dist_code(d):
    """(code 0..29, extra_bits, extra_value) for distance 1..32768.

    Matches DIST_TO_CODE/DIST_BASE/DIST_EXTRA_BITS.
    """
    dm = d - 1
    dc = jnp.maximum(dm, 1)
    bsr = bitlen(dc) - 1
    small = dm < 4
    code = jnp.where(small, dm, 2 * bsr + ((dc >> jnp.maximum(bsr - 1, 0)) & 1))
    extra_n = jnp.where(small, 0, bsr - 1)
    base_m1 = jnp.where(small, dm, (2 + (code & 1)) << jnp.maximum(bsr - 1, 0))
    return code, extra_n, dm - base_m1


def histogram_onehot(values, valid, num_bins: int):
    """Histogram via one-hot reduction (vector-unit friendly; no scatter)."""
    oh = (values[:, None] == jnp.arange(num_bins)[None, :]) & valid[:, None]
    return jnp.sum(oh.astype(jnp.int32), axis=0)


def table_lookup(table, idx, num: int):
    """Small-table lookup as a one-hot matmul.

    Chosen where it beat a gather; on the GPU a plain gather may serve
    better (not yet measured).  Exact for table values < 2**24
    (float32 integers).  ``table`` may be traced
    (per-block Huffman codes) or a host constant.

    Precision is pinned to HIGHEST: the exactness contract requires full
    float32 multiply-accumulate.  A backend whose DEFAULT lowers f32 dots
    to bf16 or TF32 (as the GPU may) would silently round table values
    wider than the format's significand (packed Huffman entries reach
    ~2**21) into corrupt bitstreams.
    """
    oh = (idx[:, None] == jnp.arange(num)[None, :]).astype(jnp.float32)
    res = jnp.dot(
        oh, table.astype(jnp.float32), precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    )
    return res.astype(jnp.int32)
