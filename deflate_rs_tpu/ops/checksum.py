"""Parallel, combinable Adler-32 and CRC-32.

The reference updates both checksums serially over the whole input
(checksum.rs:33-57 for Adler-32 via the ``adler32`` crate; CRC-32 via the
``gzip_header::Crc`` type, writer.rs:410-426).  Serial byte loops do not map to
a data-parallel device, so both are reformulated as parallel reductions:

* **Adler-32** is two modular sums: ``s1 = Σ b_i`` and ``s2 = Σ (n-i)·b_i``.
  Both are data-parallel; products are range-split so everything fits in
  int32 lanes (JAX runs with 64-bit integers disabled by default).

* **CRC-32** is linear over GF(2): the CRC register after processing a message
  with a zero initial register ("raw CRC") satisfies
  ``raw(A||B) = shift(raw(A), len(B)) ^ raw(B)`` where ``shift`` is a constant
  GF(2) 32x32 matrix per length.  We map each byte through the standard table
  (one gather) and combine with a log-depth tree whose per-level shift
  matrices are compile-time constants.

Per-chunk results are combined across chunks/devices with the same identities
(host side: :func:`adler32_combine`, :func:`crc32_combine_raw`), exactly the
"segmented-scan reduction + log-step combine" called for by the build plan.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..constants import ADLER_MOD, CRC32_POLY

# ---------------------------------------------------------------------------
# CRC-32 host-side constants
# ---------------------------------------------------------------------------


def _build_crc_table() -> np.ndarray:
    table = np.zeros(256, dtype=np.uint32)
    for b in range(256):
        c = b
        for _ in range(8):
            c = (c >> 1) ^ (CRC32_POLY if (c & 1) else 0)
        table[b] = c
    return table


CRC_TABLE = _build_crc_table()


def _gf2_matrix_times(mat: np.ndarray, vec: int) -> int:
    """Apply a GF(2) 32x32 matrix (array of 32 uint32 columns) to a 32-bit vector."""
    out = 0
    j = 0
    while vec:
        if vec & 1:
            out ^= int(mat[j])
        vec >>= 1
        j += 1
    return out


def _gf2_matrix_square(mat: np.ndarray) -> np.ndarray:
    return np.array([_gf2_matrix_times(mat, int(c)) for c in mat], dtype=np.uint32)


def _build_byte_shift_matrix() -> np.ndarray:
    """Matrix for advancing a raw CRC register past one zero byte:
    c' = (c >> 8) ^ TABLE[c & 0xFF]."""
    cols = np.zeros(32, dtype=np.uint32)
    for j in range(32):
        c = 1 << j
        cols[j] = (c >> 8) ^ CRC_TABLE[c & 0xFF]
    return cols


# SHIFT_MATRICES[k] advances a raw CRC past 2**k zero bytes.
_MAX_SHIFT_LOG2 = 48
SHIFT_MATRICES = [_build_byte_shift_matrix()]
for _ in range(_MAX_SHIFT_LOG2 - 1):
    SHIFT_MATRICES.append(_gf2_matrix_square(SHIFT_MATRICES[-1]))


def crc_shift(crc: int, num_bytes: int) -> int:
    """Advance a raw CRC register past ``num_bytes`` zero bytes (host side)."""
    k = 0
    while num_bytes:
        if num_bytes & 1:
            crc = _gf2_matrix_times(SHIFT_MATRICES[k], crc)
        num_bytes >>= 1
        k += 1
    return crc


def crc32_from_raw(raw: int, length: int) -> int:
    """Standard CRC-32 (init 0xFFFFFFFF, final xor) from a raw CRC of the data."""
    return crc_shift(0xFFFFFFFF, length) ^ raw ^ 0xFFFFFFFF


def crc32_combine_raw(raw_a: int, raw_b: int, len_b: int) -> int:
    """raw CRC of the concatenation A||B from raw CRCs of the parts."""
    return crc_shift(raw_a, len_b) ^ raw_b


# ---------------------------------------------------------------------------
# Device-side kernels
# ---------------------------------------------------------------------------


def _apply_shift_const(cols: np.ndarray, x):
    """Apply a constant GF(2) matrix to a vector of uint32 lanes.

    Vectorized over the 32 bits: mask each matrix column by the corresponding
    input bit, then XOR-fold the columns pairwise (5 steps).
    """
    from ..utils.tables import dev_const

    shifts = dev_const(_BIT_SHIFTS)
    bits = (x[:, None] >> shifts[None, :]) & 1
    masked = jnp.where(bits == 1, dev_const(cols)[None, :], 0)
    while masked.shape[1] > 1:
        half = masked.shape[1] // 2
        masked = masked[:, :half] ^ masked[:, half:]
    return masked[:, 0]


_BIT_SHIFTS = np.arange(32, dtype=np.uint32)


def crc32_raw_device(data, n):
    """Raw CRC (zero-init register, no final xor) of ``data[:n]`` on device.

    Args:
      data: uint8[P] with P a power of two; bytes at index >= n are ignored.
      n: dynamic valid length.

    Returns:
      uint32 scalar raw CRC.
    """
    P = data.shape[0]
    assert P & (P - 1) == 0, "buffer must be padded to a power of two"
    idx = jnp.arange(P, dtype=jnp.int32)
    masked = jnp.where(idx < n, data, 0).astype(jnp.uint8)
    # Front-pad: leading zero bytes are the identity for a zero-init register,
    # so roll the valid bytes to the end of the buffer.
    rolled = jnp.roll(masked, P - n)
    # Byte->CRC table lookup as two one-hot matmuls (16-bit halves stay
    # exact in float32; chosen where it beat a gather, not yet measured
    # against one on the GPU).
    from .symbolmap import table_lookup

    ridx = rolled.astype(jnp.int32)
    lo = table_lookup((CRC_TABLE & 0xFFFF).astype(np.int32), ridx, 256)
    hi = table_lookup((CRC_TABLE >> 16).astype(np.int32), ridx, 256)
    x = lo.astype(jnp.uint32) | (hi.astype(jnp.uint32) << 16)
    level = 0
    while x.shape[0] > 1:
        left = x[0::2]
        right = x[1::2]
        x = _apply_shift_const(SHIFT_MATRICES[level], left) ^ right
        level += 1
    return x[0]


def adler32_parts_device(data, n):
    """Adler-32 partial sums of ``data[:n]`` on device.

    Returns (s1, s2) as uint32 where, mod 65521:
      s1 = Σ b_i,   s2 = Σ (n - i) · b_i   (i = 0..n-1)

    For a standalone buffer: A = 1 + s1, B = n + s2 (mod 65521).
    """
    P = data.shape[0]
    idx = jnp.arange(P, dtype=jnp.int32)
    b = jnp.where(idx < n, data, 0).astype(jnp.int32)

    def seg_mod_sum(x, seg):
        """sum(x) mod ADLER_MOD without int32 overflow: reduce in segments
        (caller guarantees a segment sum fits int32), mod each, then sum the
        <= P/seg residues — int64 is unavailable without jax_enable_x64."""
        pad = (-x.shape[0]) % seg
        xs = jnp.pad(x, (0, pad)).reshape(-1, seg)
        return jnp.sum(jnp.sum(xs, axis=1) % ADLER_MOD) % ADLER_MOD

    # Range-split the weights so every PARTIAL stays inside int32 for any
    # chunk size up to ~32 MiB (q <= P/4096, so q*b <= 255*P/4096 per term;
    # a 512-term segment sum <= 512*255*P/4096 < 2**31 for P < 2**25).
    s1 = seg_mod_sum(b, 4096)  # plain sum would overflow int32 past ~8 MiB
    w = jnp.maximum(n - idx, 0)
    q, r = w // 4096, w % 4096
    sum_q = seg_mod_sum(q * b, 512)
    sum_r = seg_mod_sum(r * b, 512)  # r*b <= ~1.0e6 per term
    s2 = ((4096 % ADLER_MOD) * sum_q + sum_r) % ADLER_MOD
    return s1.astype(jnp.uint32), s2.astype(jnp.uint32)


# ---------------------------------------------------------------------------
# Host-side combination across chunks / devices
# ---------------------------------------------------------------------------


def adler32_combine(state: tuple[int, int], s1: int, s2: int, length: int) -> tuple[int, int]:
    """Fold one chunk's (s1, s2, length) into a running (A, B) Adler state."""
    a, b = state
    a2 = (a + s1) % ADLER_MOD
    b2 = (b + (length % ADLER_MOD) * a + s2) % ADLER_MOD
    return a2, b2


ADLER_INIT = (1, 0)


def adler32_value(state: tuple[int, int]) -> int:
    a, b = state
    return (b << 16) | a
