"""Optimal length-limited Huffman code lengths via vectorized package-merge.

The reference derives code lengths with the in-place Moffat–Katajainen
algorithm plus a Kraft-sum repair pass when the depth limit is exceeded
(length_encode.rs:338-415, 290-327) — an inherently sequential pointer
algorithm.  Package-merge is the data-parallel alternative: L-1 rounds of
"pair adjacent + merge with leaves", all expressible as fixed-shape sorts.
It is *exactly optimal* under the length limit, so the resulting bit cost is
<= the reference's for every block (their repair pass is only heuristic).

Leaf-counting trick: leaves enter every level's merged list in frequency
order, so the leaves selected at a level always form a prefix of the
frequency-sorted leaves.  It therefore suffices to track, per level, *how
many* leaves fall inside the selected prefix; the code length of the r-th
cheapest symbol is the number of levels whose selected-leaf count exceeds r.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

_BIG = 1 << 29  # value sentinel for padding; sums are clamped below it


def package_merge_rows(freqs, max_len: int):
    """:func:`package_merge_lengths` over each row of ``freqs: int32[R, A]``."""
    return jax.vmap(functools.partial(package_merge_lengths, max_len=max_len))(freqs)


def package_merge_lengths(freqs, max_len: int):
    """Optimal code lengths for ``freqs`` under a ``max_len``-bit limit.

    Args:
      freqs: int32[A] symbol frequencies (0 = unused). Frequencies must be
        < 2**20 so sort keys and package sums stay inside int32.
      max_len: static depth limit (15 for litlen/dist, 7 for clen).

    Returns:
      int32[A] code lengths; 0 for unused symbols.  All-zero if no symbol is
      used; a single used symbol gets length 1 (as the reference does).
    """
    A = freqs.shape[0]
    sym = jnp.arange(A, dtype=jnp.int32)
    active = freqs > 0
    m = jnp.sum(active.astype(jnp.int32))

    # Frequency-sorted leaves (stable tie-break on symbol index => canonical
    # and deterministic across backends).
    leaf_key = jnp.where(active, freqs * 512 + sym, _BIG + sym)
    perm = jnp.argsort(leaf_key).astype(jnp.int32)  # rank -> symbol
    leaf_vals = jnp.where(active[perm], freqs[perm], _BIG)

    S = 2 * A

    # Each level's merged list is kept as ONE packed array: value*2 | kind,
    # kind bit 0 = leaf, 1 = package.  Value order with leaves-before-
    # packages tie-break is then plain integer order, so every level is a
    # single-operand sort (payload-free sorts are the cheapest form).  Values stay < 2*_BIG < 2^30, safe in
    # int32.
    leaf_packed = leaf_vals * 2
    pad_packed = jnp.full(A, _BIG * 2 + 1, dtype=jnp.int32)

    # Build levels from deepest (leaves only) to level 1 (fully merged).
    levels_cum_leaves = []  # deepest first
    packed = jnp.concatenate([leaf_packed, pad_packed])
    levels_cum_leaves.append(jnp.cumsum(1 - (packed & 1)))
    for _ in range(max_len - 1):
        pair_vals = jnp.minimum((packed[0::2] >> 1) + (packed[1::2] >> 1), _BIG)
        packed = jnp.sort(jnp.concatenate([leaf_packed, pair_vals * 2 + 1]))
        levels_cum_leaves.append(jnp.cumsum(1 - (packed & 1)))

    # Select the first 2m-2 entries of level 1, propagating package counts
    # down: each selected package at level t selects its two halves at t+1.
    lengths_by_rank = jnp.zeros(A, dtype=jnp.int32)
    n_sel = jnp.maximum(2 * m - 2, 0)
    for cum_leaves in reversed(levels_cum_leaves):  # level 1 .. level L
        take = jnp.clip(n_sel, 0, S)
        leaf_count = jnp.where(take > 0, cum_leaves[jnp.maximum(take - 1, 0)], 0)
        lengths_by_rank = lengths_by_rank + (jnp.arange(A) < leaf_count)
        n_sel = 2 * (take - leaf_count)

    lengths = jnp.zeros(A, dtype=jnp.int32).at[perm].set(lengths_by_rank)
    # Corner cases: 0 or 1 used symbols.
    single = jnp.where(active, 1, 0)
    lengths = jnp.where(m > 1, lengths, jnp.where(m == 1, single, 0))
    return jnp.where(active, lengths, 0)
