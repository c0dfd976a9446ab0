"""Parse resolution: greedy/lazy selection + parallel token extraction.

The reference resolves greedy vs lazy with a sequential per-byte state machine
(``process_chunk_lazy``, lz77.rs:305-486).  The key observation for the
data-parallel reformulation: both policies are *local* decisions once every position's best
match is known —

* greedy: take the match at i iff one exists;
* lazy (zlib-style deferral): at i with match length L, if L is below the
  ``lazy_if_less_than`` threshold and position i+1 has a strictly longer
  match, emit a literal and move to i+1 (where the same rule applies again,
  reproducing chained deferral).

Encoding each decision as a jump ``next[i]`` (i+1 for a literal, i+len for a
match) turns the parse into the orbit of the start position under ``next``,
which is computed with log-depth pointer doubling — no sequential scan.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..constants import MIN_MATCH, TOO_FAR


def build_jumps(best_len, best_dist, lazy: bool, lazy_if_less_than: int):
    """Jump steps per position: 1 for a literal, match length for a match.

    Matches of length 3 at distance > TOO_FAR are dropped, mirroring
    match_too_far (lz77.rs:274-278).
    """
    length = jnp.where((best_len == MIN_MATCH) & (best_dist > TOO_FAR), 0, best_len)
    has_match = length >= MIN_MATCH

    if lazy:
        # Match length available at i+1 (0 beyond the end).
        next_len = jnp.concatenate([length[1:], jnp.zeros(1, dtype=length.dtype)])
        defer = has_match & (length < lazy_if_less_than) & (next_len > length)
        take = has_match & ~defer
    else:
        take = has_match

    return jnp.where(take, length, 1).astype(jnp.int32)


def reachable(nxt, start: int):
    """Boolean mask of positions in the orbit of ``start`` under ``nxt``.

    Log-depth pointer doubling: after step s the mask covers all
    ``nxt^m(start)`` with m < 2**(s+1).
    """
    n1 = nxt.shape[0]  # N + 1
    reach = jnp.zeros(n1, dtype=jnp.bool_).at[start].set(True)
    hop = nxt
    steps = max(1, (n1 - 1).bit_length())
    for _ in range(steps):
        stepped = jnp.zeros(n1, dtype=jnp.bool_).at[hop].max(reach)
        reach = reach | stepped
        hop = hop[hop]
    return reach


def token_starts(steps, n):
    """Token-start mask of a chunk: the orbit of position 0 under ``steps``.

    Args:
      steps: int32[E] jump steps from :func:`build_jumps`.
      n: dynamic payload length; positions >= n are never token starts.
    """
    E = steps.shape[0]
    nxt = jnp.minimum(jnp.arange(E, dtype=jnp.int32) + steps, E)
    reach = reachable(jnp.concatenate([nxt, jnp.full(1, E, jnp.int32)]), 0)
    return reach[:E] & (jnp.arange(E) < n)
