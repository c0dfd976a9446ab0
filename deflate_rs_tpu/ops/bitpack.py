"""Parallel LSB-first bit concatenation — scatter-free.

Replaces the reference's sequential ``LsbWriter::write_bits`` accumulator loop
(bitstream.rs:76-86, the second-hottest loop) with a data-parallel scheme
built only from a cumsum, one sort, and elementwise ops (no gathers or
scatters, which were scalar-bound on the encoder's first target device):

1. every emitted quantity becomes a (value, nbits) *field*;
2. an exclusive prefix-sum over ``nbits`` yields each field's absolute bit
   offset, hence its output word ``off >> 5`` and phase ``off & 31``;
3. fields are CONTIGUOUS in bit space, and each is at most 32 bits wide, so
   every output word (up to the last) contains at least one field start.
   Therefore each word has exactly one "boundary" field — the last field
   starting in it — and the running uint32 sum of shifted low contributions,
   differenced at consecutive boundaries, is exactly the OR of that word's
   contributions (they are bitwise-disjoint; mod-2^32 wraparound cancels in
   the difference);
4. the straddling carry of word w's boundary field into word w+1 is folded
   into the running sum as an EXCLUSIVE cumsum of boundary carries, so the
   boundary differences recover (word contribution | carry-in) directly —
   carry bits sit below the first in-word field's phase, so ADD == OR;
5. boundary fields are compacted into word order with one stable sort
   (boundaries are already in word order, so the sort is a partition); a
   trailing zero-width sentinel field guarantees the final partial word has
   a boundary even when no real field starts in it.

DEFLATE's LSB-first bit order is exactly little-endian uint32 word order, so
the word buffer reinterpreted as bytes IS the bitstream.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def pack_fields(values, nbits, num_words: int):
    """Pack bit fields into a little-endian uint32 word buffer.

    Args:
      values: uint32[F] field values (only the low ``nbits`` bits are used).
      nbits: int32[F] field widths, 0..32; width-0 fields are skipped.
      num_words: static output buffer size in 32-bit words (must not exceed
        the field count — true for every chunk configuration, asserted).

    Returns:
      (words: uint32[num_words], total_bits: int32 scalar).
    """
    F = values.shape[0]
    assert F >= num_words, (F, num_words)
    # Trailing zero-width sentinel: its offset is total_bits, so it lands in
    # (and becomes the boundary of) the final partial word even when no real
    # field starts there — e.g. a 16-bit tail field straddling into the last
    # word.  Without it that word's straddle carry would be dropped (the
    # carry is recovered at the NEXT boundary's difference, which must
    # therefore exist).  Also guarantees the word beyond a 32-aligned end is
    # masked junk rather than read.
    values = jnp.concatenate([values, jnp.zeros(1, values.dtype)])
    nbits = jnp.concatenate([nbits, jnp.zeros(1, nbits.dtype)])
    nbits = nbits.astype(jnp.uint32)
    # Mask values to their declared width (up to 32 bits per field) so word
    # contributions stay bitwise-disjoint.  2 << (nbits-1) == 2**nbits
    # without a shift-by-32; the nbits == 0 case is selected away.
    mask = jnp.where(
        nbits == 0, 0, jnp.left_shift(2, nbits - 1).astype(jnp.uint32) - 1
    ).astype(jnp.uint32)
    vals = values.astype(jnp.uint32) & mask

    ends = jnp.cumsum(nbits, dtype=jnp.uint32)
    offs = ends - nbits  # exclusive prefix-sum
    total_bits = ends[-1]

    word = (offs >> 5).astype(jnp.int32)
    sh = offs & 31
    lo = vals << sh
    hi = jnp.where(sh == 0, 0, vals >> (32 - sh)).astype(jnp.uint32)

    # Last field starting in each word.  Zero-width fields share their
    # successor's offset, so they are never boundaries (except a trailing
    # run, where flagging the final field is harmless: its lo is 0).
    nxt_word = jnp.concatenate([word[1:], jnp.full(1, -1, jnp.int32)])
    boundary = word != nxt_word

    # Fold the straddle carry into the prefix sum: with s = EXCLUSIVE cumsum
    # of boundary his, (ps+s) differenced at consecutive boundaries yields
    # word_diff + hi[prev_boundary] — and the carry bits are disjoint from
    # the word's own contributions (the carry fills bits below the first
    # in-word field's phase), so ADD == OR.  One sort payload instead of two.
    hi_b = jnp.where(boundary, hi, 0)
    # ps = cumsum(lo) + (cumsum(hi_b) - hi_b), folded into ONE cumsum:
    # cumsum(lo + hi_b) - hi_b.  Mod 2^32; wrap cancels in the differences.
    ps = jnp.cumsum(lo + hi_b, dtype=jnp.uint32) - hi_b
    # Compact boundaries with an UNSTABLE single-key sort: every word up to
    # the last contains a field start, so boundary word indices are both
    # unique and gap-free — the boundary for word w sorts exactly to rank w.
    # (A stable sort makes XLA add an internal iota tiebreak key; unique
    # keys need no tiebreak.)  Non-boundary rows share
    # key ``num_words`` and land past every real word, where the
    # total_bits mask below zeroes them.
    key = jnp.where(boundary, word, jnp.int32(num_words))
    srt = jax.lax.sort([key, ps], num_keys=1, is_stable=False)
    t = srt[1][:num_words]
    t_prev = jnp.concatenate([jnp.zeros(1, jnp.uint32), t[:-1]])
    out = t - t_prev

    # Beyond the last real word the compaction holds non-boundary junk.
    widx = jnp.arange(num_words, dtype=jnp.uint32)
    out = jnp.where(widx * 32 < total_bits, out, 0)
    return out, total_bits.astype(jnp.int32)


def words_to_bytes(words):
    """uint32[W] little-endian words -> uint8[4W] bytes (device side)."""
    w = words[:, None]
    shifts = jnp.arange(4, dtype=jnp.uint32) * 8
    return ((w >> shifts[None, :]) & 0xFF).astype(jnp.uint8).reshape(-1)
