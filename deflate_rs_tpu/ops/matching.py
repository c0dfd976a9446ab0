"""Vectorized longest-match search, gather-free on the hot path.

Replaces the reference's per-byte hash-chain walk (``longest_match``,
matching.rs:87 — its hottest function).  The design comes from the
encoder's first target device, whose gathers and scatters ran on a scalar
unit, so per-candidate gathers were unaffordable there; it has not yet been
measured against a gather-based matcher on the GPU.  The hot path uses only sorts, shifts,
scans and elementwise ops:

1. **Payload sort**: positions are sorted by 3-byte hash with their probe
   words (the first 16 bytes, packed) carried as sort payloads — a
   multi-operand ``lax.sort``.  After the sort, the k-th most recent same-hash candidate of a
   position is simply the row k above it: the entire hash-chain neighborhood
   becomes *shifted slices*, no gathers.
2. **Probe**: for k = 1..K, compare each row's probe words against the row
   k above, tracking the best (length, distance) as a packed score.
3. **Chain extension** (in position space, after one packed unsort scatter):
   matches longer than the 16-byte probe window are recovered from the run
   structure of the best distances themselves.  If positions i..j-1 all hold
   a valid match at the SAME distance d, then every byte in [i, j+2) equals
   the byte d back (each position's probe proved its own first 3 bytes), so
   the match at i provably extends to j - i + 2 bytes.  One reverse min-scan
   over "distance changed or no match" break points yields this for every
   position at once — no gathers, no per-candidate walks, and it is exact
   precisely where long matches live (runs and repeated blocks keep a
   constant best distance).  Claimed lengths are always valid (never
   overclaim), which is all DEFLATE requires.

Any parse found this way is legal DEFLATE; only compressed size depends on
the candidate policy (same argument as the reference's insertion-order note).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..constants import MAX_MATCH, WINDOW_SIZE
from .hashing import INVALID_KEY, hash3

# Default probe window carried through the sort, in 4-byte words.  Wider
# probes measure longer matches exactly before chain extension takes over;
# presets pick their own width (CompressionOptions.probe_words).
PROBE_WORDS = 8


def pack_words(data_padded):
    """P[i] = data[i] | data[i+1]<<8 | data[i+2]<<16 | data[i+3]<<24 (uint32).

    ``data_padded`` must have at least 3 bytes of padding beyond the last index
    that will be read.
    """
    d = data_padded.astype(jnp.uint32)
    return d[:-3] | (d[1:-2] << 8) | (d[2:-1] << 16) | (d[3:] << 24)


def _matched_bytes(x):
    """Number of matching low-order bytes in an XOR'd packed word (0..4)."""
    m0 = (x & 0x000000FF) == 0
    m1 = (x & 0x0000FFFF) == 0
    m2 = (x & 0x00FFFFFF) == 0
    m3 = x == 0
    return m0.astype(jnp.int32) + m1 + m2 + m3


def _probe_len(words_a, words_b):
    """Matched-byte count between two probe windows (lists of word arrays)."""
    total = None
    for w, (a, b) in enumerate(zip(words_a, words_b)):
        m = _matched_bytes(a ^ b)
        total = m if total is None else total + jnp.where(total == 4 * w, m, 0)
    return total


def stride_extend(best_len, best_dist, limit, strides=(16, 32, 64, 128)):
    """Compose same-distance matches across log-spaced strides (gather-free).

    If position i matches at distance d for l >= s bytes and position i+s
    also matches at distance d, the two matches are contiguous at d, so i
    provably matches for s + len(i+s) bytes.  Iterating ascending strides
    doubles the reachable length each round (16+32+64+128 + probe cap > 258)
    with nothing but shifted elementwise compares — the recovery path for
    LONG matches, whose true length the probe window caps (repetitive
    corpora: license texts, JSON configs; measured -8.6%/-48% vs zlib-6
    before this pass).  Composes only ever-valid claims, so it never
    overclaims; lengths stay clipped by each position's own limit.
    """
    l, d = best_len, best_dist
    for s in strides:
        l_s = jnp.concatenate([l[s:], jnp.zeros(s, l.dtype)])
        d_s = jnp.concatenate([d[s:], jnp.zeros(s, d.dtype)])
        ok = (d > 0) & (d_s == d) & (l >= s)
        l = jnp.where(ok, jnp.maximum(l, s + l_s), l)
    return jnp.minimum(l, limit)


def chain_extend(best_len, best_dist, limit, N: int):
    """Extend probe-measured matches along constant-distance runs (exact,
    never overclaims; see module docstring step 3)."""
    idx = jnp.arange(N, dtype=jnp.int32)
    ok = best_len >= 3
    d_prev = jnp.concatenate([jnp.zeros(1, best_dist.dtype) - 1, best_dist[:-1]])
    bad = ~ok | (best_dist != d_prev)
    first_bad = jax.lax.cummin(jnp.where(bad, idx, N), axis=0, reverse=True)
    # First break strictly AFTER i; the last matched position still proves
    # its own 3 probe bytes, hence the +2.
    first_bad_after = jnp.concatenate([first_bad[1:], jnp.full(1, N, jnp.int32)])
    l_chain = jnp.minimum(first_bad_after - idx + 2, limit)
    return jnp.where(ok, jnp.maximum(best_len, l_chain), 0)


def _probe_schedule(K: int, dense_frac: float = 0.875, growth: float = 0.04):
    """Chain depths probed by find_matches_hash: ``dense_frac`` of the
    budget walks the most recent rows densely, the rest continues at
    geometrically growing spacing (factor 1 + ``growth``), reaching chain
    depth several times the budget.  dense_frac was retuned 0.75 -> 0.875
    in round 5: at the same probe count it improved the high preset on
    EVERY in-image corpus (pg11 60102 -> 60066; worst z9 margin 0.9963 ->
    0.9961) — mid-depth density beats
    maximum reach on this corpus set."""
    ks, k = [], 1
    while len(ks) < K:
        ks.append(k)
        k += 1 if len(ks) < int(dense_frac * K) else max(1, int(k * growth))
    return ks


def find_matches_hash(buf, N: int, n_total, hstart, num_checks: int,
                      probe_words: int = PROBE_WORDS):
    """Best (length, distance) at every position of one chunk buffer.

    Args:
      buf: uint8[N + PAD] chunk buffer (history + payload + padding).
      N: static number of positions.
      n_total: dynamic end of valid bytes.
      hstart: dynamic first valid position (history start).
      num_checks: static K — how many sorted-space predecessors to probe.
      probe_words: static probe window width in 4-byte words.

    Returns:
      (best_len, best_dist): int32[N]; best_len == 0 where no match of
      length >= 3 exists.  Lengths capped at min(258, n_total - i).
    """
    idx = jnp.arange(N, dtype=jnp.int32)
    limit = jnp.clip(n_total - idx, 0, MAX_MATCH)

    # ---------------------------------------------------------------- hash
    h = hash3(buf, N)
    hashable = (idx >= hstart) & (idx <= n_total - 3)
    keys = jnp.where(hashable, h, INVALID_KEY)

    packed = pack_words(buf)
    probe_pos = [packed[4 * w : N + 4 * w] for w in range(probe_words)]

    # ------------------------------------------------- payload sort by hash
    sorted_ops = jax.lax.sort([keys, idx] + probe_pos, num_keys=1, is_stable=True)
    skey, spos = sorted_ops[0], sorted_ops[1]
    sprobe = sorted_ops[2:]

    # ------------------------------------- probe K sorted-space predecessors
    # Row r-k is the k-th most recent prior position with this hash.  Rolled
    # into a fori_loop (dynamic-sliced shifts) to keep the graph small; each
    # iteration is pure elementwise work over shifted rows — no gathers.
    #
    # Probe SCHEDULE: three quarters of the budget probes the most recent
    # chain rows densely; the rest continues at geometrically growing
    # spacing, reaching chain depth several times the budget.  Dense-only probing
    # cannot see past the most recent K same-hash positions, which on
    # crowded hashes (JSON keys, license boilerplate) is a ~1-2 KiB horizon
    # — the reference's high preset walks 1768 links for exactly this reason
    # (compression_options.rs:126-133).  Each probed candidate is measured
    # independently over the full probe window, so a sparse deep sample
    # still yields exact (capped) lengths.
    K = num_checks
    ks = _probe_schedule(K)
    import numpy as _np

    ks_arr = _np.array(ks, _np.int32)
    KMAX = int(ks_arr[-1])
    valid_row = skey < INVALID_KEY

    skey_ext = jnp.concatenate([jnp.full((KMAX,), INVALID_KEY + 1, skey.dtype), skey])
    spos_ext = jnp.concatenate([jnp.zeros((KMAX,), spos.dtype), spos])
    sprobe_ext = [jnp.concatenate([jnp.zeros((KMAX,), w.dtype), w]) for w in sprobe]

    def probe_step(i, best):
        start = KMAX - jnp.take(ks_arr, i)
        pk = jax.lax.dynamic_slice(skey_ext, [start], [N])
        ppos = jax.lax.dynamic_slice(spos_ext, [start], [N])
        dist = spos - ppos
        ok = (skey == pk) & valid_row & (dist <= WINDOW_SIZE)
        lp = _probe_len(
            sprobe, [jax.lax.dynamic_slice(w, [start], [N]) for w in sprobe_ext]
        )
        score = jnp.where(ok & (lp >= 3), (lp << 16) | (WINDOW_SIZE + 1 - dist), 0)
        return jnp.maximum(best, score)

    # Carry zeros derived from a varying operand so the loop type-checks
    # under shard_map's varying-manual-axes tracking (spos*0 is varying where
    # a literal zeros array is not).
    best = jax.lax.fori_loop(0, K, probe_step, spos * 0)

    # ------------------------------------------------ unsort + chain extend
    # Un-permute via a second sort keyed by position: spos is a permutation
    # of iota, so sorting (spos, best) restores position order (chosen where
    # it beat a scatter; not yet measured against one on the GPU).
    score_pos = jax.lax.sort([spos, best], num_keys=1, is_stable=False)[1]
    blen = jnp.minimum(score_pos >> 16, limit)
    bdist = jnp.where(score_pos > 0, WINDOW_SIZE + 1 - (score_pos & 0xFFFF), 0)

    best_len = stride_extend(chain_extend(blen, bdist, limit, N), bdist, limit)
    good = best_len >= 3
    return jnp.where(good, best_len, 0), jnp.where(good, bdist, 0)


def sa_scan_xla(skeys, spos, spay, hstart, n_total, num_checks: int,
                probe_words: int, tail_jumps: tuple = ()):
    """Suffix-order LCP + K-deep running-min scan (both backends).

    ``tail_jumps``: optional log2 jump sizes appended after the dense K-deep
    scan.  Each jump of 2^j rows extends the running-min LCP EXACTLY via a
    sparse min-table (M_j[i] = min of 2^j adjacent LCPs ending at row i), so
    one extra step samples a candidate 2^j rows deeper with the true LCP —
    reaching thousands-deep tie groups (repeated JSON keys, license
    boilerplate; the reference's high preset walks 1768 chain links for the
    same reason, compression_options.rs:126-133) at a handful of steps.
    Sampled-depth candidates between jumps are skipped (ratio, not
    correctness: the running min is the exact LCP at every examined depth).
    """
    NKEY = len(skeys)
    N = spos.shape[0]

    # --------------------------- adjacent-row LCP (bytes, <= 4*probe_words)
    total = None
    for w in range(NKEY):
        a = skeys[w]
        b = jnp.concatenate([jnp.full((1,), ~a[0], a.dtype), a[:-1]])
        m = jnp.minimum(jax.lax.clz(a ^ b) >> 3, 4).astype(jnp.int32)
        total = m if total is None else total + jnp.where(total == 4 * w, m, 0)
    for w, p in enumerate(spay, start=NKEY):
        b = jnp.concatenate([jnp.zeros((1,), p.dtype), p[:-1]])
        total = total + jnp.where(total == 4 * w, _matched_bytes(p ^ b), 0)
    al = total.at[0].set(0)

    # ------------------- K-deep running-min scan, both suffix-order sides
    K = num_checks
    DEEP = K + sum(1 << j for j in tail_jumps)
    svalid = (spos >= hstart) & (spos <= n_total - 3)
    al_b = jnp.concatenate([jnp.zeros((DEEP,), jnp.int32), al])
    pos_b = jnp.concatenate([jnp.full((DEEP,), jnp.int32(-(1 << 30))), spos])
    al_f = jnp.concatenate([al, jnp.zeros((DEEP,), jnp.int32)])
    pos_f = jnp.concatenate([spos, jnp.full((DEEP,), jnp.int32(1 << 30))])

    def score_at(runb, runf, cb, cf, best):
        db = spos - cb
        df = spos - cf
        okb = (db >= 1) & (db <= WINDOW_SIZE) & (cb >= hstart) & (runb >= 3)
        okf = (df >= 1) & (df <= WINDOW_SIZE) & (cf >= hstart) & (runf >= 3)
        sb = jnp.where(okb, (runb << 16) | (WINDOW_SIZE + 1 - db), 0)
        sf = jnp.where(okf, (runf << 16) | (WINDOW_SIZE + 1 - df), 0)
        return jnp.maximum(best, jnp.maximum(sb, sf))

    def step(k, carry):
        runb, runf, best = carry
        ab = jax.lax.dynamic_slice(al_b, [DEEP - k + 1], [N])
        cb = jax.lax.dynamic_slice(pos_b, [DEEP - k], [N])
        af = jax.lax.dynamic_slice(al_f, [k], [N])
        cf = jax.lax.dynamic_slice(pos_f, [k], [N])
        runb = jnp.minimum(runb, ab)
        runf = jnp.minimum(runf, af)
        return runb, runf, score_at(runb, runf, cb, cf, best)

    init = spos * 0 + 4 * probe_words
    runb, runf, best = jax.lax.fori_loop(1, K + 1, step, (init, init, spos * 0))
    if not tail_jumps:
        return jnp.where(svalid, best, 0)

    # ----------------------------- log-step tail over the sparse min-table
    # M_j[i] = min(al[i - 2^j + 1 .. i]); built by doubling (j levels of one
    # shifted elementwise min each).  Jump from depth k to k' = k + 2^j:
    #   backward: extra window al[i-k'+1 .. i-k]  == M_j at row  i - k
    #   forward:  extra window al[i+k+1  .. i+k'] == M_j at row  i + k'
    max_j = max(tail_jumps)
    M = [al]
    for j in range(1, max_j + 1):
        s = 1 << (j - 1)
        prev = M[-1]
        shifted = jnp.concatenate([jnp.zeros((s,), jnp.int32), prev[:-s]])
        M.append(jnp.minimum(prev, shifted))
    k = K
    for j in tail_jumps:
        s = 1 << j
        k2 = k + s
        Mb = jnp.concatenate([jnp.zeros((DEEP,), jnp.int32), M[j]])
        Mf = jnp.concatenate([M[j], jnp.zeros((DEEP,), jnp.int32)])
        runb = jnp.minimum(runb, jax.lax.dynamic_slice(Mb, [DEEP - k], [N]))
        runf = jnp.minimum(runf, jax.lax.dynamic_slice(Mf, [k2], [N]))
        cb = jax.lax.dynamic_slice(pos_b, [DEEP - k2], [N])
        cf = jax.lax.dynamic_slice(pos_f, [k2], [N])
        best = score_at(runb, runf, cb, cf, best)
        k = k2
    return jnp.where(svalid, best, 0)


def find_matches(buf, N: int, n_total, hstart, num_checks: int,
                 probe_words: int = PROBE_WORDS, nkey: int = 0,
                 tail_jumps: tuple = ()):
    """Best (length, distance) per position via a bounded suffix sort.

    The round-2 matcher: instead of sorting by 3-byte *hash* and probing K
    chain predecessors with full 16-byte compares (find_matches_hash), sort
    by the first 16 bytes of *content* — four big-endian packed words as
    lexicographic sort keys, so unsigned word order == byte order.  In this
    bounded suffix order:

    * the longest-prefix candidates for a position are its immediate sorted
      neighbors (both directions, unlike a hash chain's one);
    * the match length with the neighbor k rows away is the running MIN of
      adjacent-row LCPs (string LCP is an ultrametric), so the whole K-deep
      candidate scan is one LCP array + 2K running-min steps of ~12
      elementwise ops — ~7x less compare work per step than re-probing
      16-byte windows per candidate.

    Adjacent LCPs are exact to 4*probe_words bytes: `clz(xor)` on the four
    big-endian key words, then little-endian payload words (bytes 16..) carried
    through the sort extend them, gated on the prefix being fully equal so far.

    Invalid rows (outside [hstart, n_total-3]) get all-0xFF keys: they sort to
    the end, and the LCP *through* such a hybrid row is still a valid lower
    bound for any pair spanning it (ultrametric inequality holds for any
    middle string), so they can only underclaim, never corrupt.  They are
    additionally excluded as candidates/owners by explicit position checks.

    Replaces the reference's hash-chain `longest_match` (matching.rs:87) at
    equal-or-better ratio for half the chain budget; never overclaims, so any
    resulting parse is legal DEFLATE.
    """
    idx = jnp.arange(N, dtype=jnp.int32)
    limit = jnp.clip(n_total - idx, 0, MAX_MATCH)
    valid = (idx >= hstart) & (idx <= n_total - 3)

    # Key count: nkey < 4 sorts a shorter exact
    # content prefix, leaving in-tie order by position (most recent last),
    # and the LCP chain below measures through payload words regardless.
    # Correctness is unaffected (the running-min LCP is a valid lower bound
    # in ANY row order; see the invalid-row note below), only which
    # candidates end up adjacent — i.e. ratio.
    NKEY = min(nkey, 4, probe_words) if nkey else min(4, probe_words)
    d = buf.astype(jnp.uint32)
    be = (d[:-3] << 24) | (d[1:-2] << 16) | (d[2:-1] << 8) | d[3:]
    keys = [
        jnp.where(valid, be[4 * w : N + 4 * w], jnp.uint32(0xFFFFFFFF))
        for w in range(NKEY)
    ]
    packed = pack_words(buf)
    pay = [packed[4 * w : N + 4 * w] for w in range(NKEY, probe_words)]

    ops = jax.lax.sort(keys + [idx] + pay, num_keys=NKEY, is_stable=True)
    skeys, spos, spay = list(ops[:NKEY]), ops[NKEY], list(ops[NKEY + 1 :])

    best = sa_scan_xla(skeys, spos, spay, hstart, n_total, num_checks,
                       probe_words, tail_jumps=tail_jumps)

    # ------------------------------------------------ unsort + chain extend
    # Un-permute via a second sort keyed by position (see find_matches_hash).
    score_pos = jax.lax.sort([spos, best], num_keys=1, is_stable=False)[1]
    blen = jnp.minimum(score_pos >> 16, limit)
    bdist = jnp.where(score_pos > 0, WINDOW_SIZE + 1 - (score_pos & 0xFFFF), 0)

    best_len = stride_extend(chain_extend(blen, bdist, limit, N), bdist, limit)
    good = best_len >= 3
    return jnp.where(good, best_len, 0), jnp.where(good, bdist, 0)


def find_rle_matches(data_padded, n_total, hstart, N: int):
    """Distance-1 run matching only (the reference's RLE mode, rle.rs:23-63)."""
    idx = jnp.arange(N, dtype=jnp.int32)
    eq = jnp.concatenate(
        [jnp.zeros((1,), jnp.bool_), data_padded[1:N] == data_padded[: N - 1]]
    )
    eq = eq & (idx - 1 >= hstart) & (idx < n_total)
    big = N + MAX_MATCH
    breaks = jnp.where(eq, big, idx)
    next_break = jax.lax.cummin(breaks, axis=0, reverse=True)
    max_len = jnp.clip(n_total - idx, 0, MAX_MATCH)
    length = jnp.minimum(next_break - idx, max_len)
    best_len = jnp.where(length >= 3, length, 0)
    best_dist = jnp.where(best_len > 0, 1, 0)
    return best_len, best_dist
