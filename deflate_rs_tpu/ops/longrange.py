"""Long-range match recovery: exact lengths at locally dominant distances.

The main matcher (matching.py) measures candidate matches through a probe
window of 4*probe_words bytes; chain/stride extension recovers longer
matches only where consecutive positions agree on a distance.  On corpora of
concatenated similar-but-not-identical files (license texts, JSON configs,
Python sources) the tie group at every position is full of short-lived near
candidates, so chosen distances vary position to position and long matches
are emitted as ~probe-window fragments — measured token histograms showed a
4x pile-up in the 17-32-byte bucket vs zlib-6's parse on the json corpus,
costing up to 36% in size.

The recovery exploits locality of repeat structure instead of measuring
every candidate of every position (per-candidate gathers were scalar-bound
on the encoder's first target device; not yet measured on the GPU):

1. HARVEST: every position whose claim hit the probe cap contributes its
   chosen distance as a candidate (the true length there is unknown).
2. DOMINANTS: reshape candidates to [num_seg, *] segment rows; each row's
   top ``num_dom`` distances by frequency come from one batched row sort +
   run-length counting + top_k.  Within a small segment the capped claims
   concentrate on a handful of file-to-file offsets.
3. MEASURE: for each (segment, dominant distance), the run structure of
   ``buf[x] == buf[x-d]`` over the segment — entirely at WORD granularity.

This file keeps every per-(segment,dominant) array in word space: the
per-byte work of a byte-granular form ([S, M, L] byte arrays) is replaced by

  * phase-decomposed uint32 compares: ``P[x] == P[x-d]`` for the packed
    word array P (P[x] covers bytes x..x+3), evaluated on the 4-aligned
    grid.  The shifted operand ``P[base-d+4k]`` is a contiguous slice of
    the phase array ``P[(base-d) % 4 :: 4]`` — four host-free strided
    views, each sliced per (s, m) (XLA lowers the vmapped slices to one
    row gather);
  * the run-from-word-start scan (``pval``/cummin — the same packed-prefix
    trick as round 3) on [S, M, LW];
  * a max/argmax over dominants PER WORD, not per byte: ``run0[s, w]`` =
    best run starting at word w's first byte, with the winning distance
    and the winning candidate's xor word;
  * one O(N) byte-expansion: a position at in-word offset o > 0 claims
    through ITS word's tail at the distance that wins word w+1, i.e.
    ``eo + run0_win[w+1]`` where eo counts matching bytes o..3 under the
    winner's xor.  This is a provable (never overclaiming) lower bound; it
    can under-claim only when a different dominant matches the ≤3 tail
    bytes AND wins by less than those bytes — irrelevant here because LR
    claims only displace matcher claims beyond the probe cap (>= ~24 B),
    where the word-start run dominates.

Lengths are exact byte runs under the winning distance — never
overclaimed, so any resulting parse stays legal DEFLATE.

The reference reaches the same matches by walking per-position hash chains
to depth 1768 with full byte compares (matching.rs:87,
compression_options.rs:126-133); this pass replaces that reach for the
price of ~num_seg*num_dom vectorized word-row scans.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..constants import MAX_MATCH, WINDOW_SIZE


def _matched_low_bytes(x):
    """Number of matching low-order bytes of an XOR'd packed word (0..4)."""
    m0 = (x & 0x000000FF) == 0
    m1 = (x & 0x0000FFFF) == 0
    m2 = (x & 0x00FFFFFF) == 0
    m3 = x == 0
    return m0.astype(jnp.int32) + m1 + m2 + m3


def union_dominants(d_cand, num_seg: int, num_dom: int, num_global: int, *,
                    harvest_stride: int = 4, sel: str = "freq",
                    pair: bool = False):
    """Static-width union of per-segment dominant distances.

    Per-segment top-``num_dom`` selection exactly as in
    :func:`local_dominant_lengths` (locality is what makes the frequency
    ranking work — a global ranking was measured 19% worse on json), then
    the S x M selections are deduped into ONE sorted list padded to
    ``num_global`` entries (0 = inert).  Every distance is then measured
    over the whole chunk, which is a superset of the local design's claims.
    """
    S, M, D = num_seg, num_dom, num_global
    doms, topf = _select_dominants(d_cand, S, M, harvest_stride, sel=sel,
                                   pair=pair)

    # Union to D static slots ranked by TOTAL frequency: sort the S*M
    # (value, freq) pairs by value, sum freqs over equal-value runs (scan
    # tricks, no gathers), then top-D runs by summed frequency.  Truncation
    # keeps the globally most-harvested distances — an ascending-value cut
    # was measured to throw away exactly the large file-to-file offsets the
    # pass exists for.
    flat_v = doms.reshape(-1)
    flat_f = jnp.where(flat_v > 0, topf.reshape(-1), 0)
    v, f = jax.lax.sort([flat_v, flat_f], num_keys=1, is_stable=False)
    g = jnp.cumsum(f)
    gprev = jnp.concatenate([jnp.zeros(1, g.dtype), g[:-1]])
    change2 = jnp.concatenate([jnp.ones(1, bool), v[1:] != v[:-1]])
    base_g = jax.lax.cummax(jnp.where(change2, gprev, 0))
    last = jnp.concatenate([change2[1:], jnp.ones(1, bool)])
    runtot = jnp.where(last & (v > 0), g - base_g, 0)  # at each run's last row
    Deff = min(D, S * M)
    tot_d, idx_d = jax.lax.top_k(runtot, Deff)
    dlist = jnp.where(tot_d > 0, jnp.take(v, idx_d), 0)
    if D > S * M:
        dlist = jnp.concatenate([dlist, jnp.zeros(D - S * M, jnp.int32)])
    return dlist


def global_dominant_lengths(buf, N: int, n_total, hstart, d_cand, *,
                            num_dom: int = 4, num_seg: int = 32,
                            num_global: int = 64, harvest_stride: int = 4,
                            sel: str = "freq", pair: bool = False):
    """Per-position lengths at the chunk's unioned dominant distances.

    The gather-free sibling of :func:`local_dominant_lengths`: instead of
    S x M per-segment window slices (a ~1000-row gather), every unioned
    distance is measured over the WHOLE chunk.  The per-distance shifted operand is
    ONE contiguous dynamic slice, collected into a [D, NW] buffer by a
    fori_loop of contiguous copies; compares, the packed-prefix run scan,
    and the cross-distance winner reduction then run as plain batched
    elementwise/scan work.  Byte expansion as in the local variant.

    Returns (best_len, best_dist): int32[N], 0 where no claim.
    """
    D = num_global
    assert N % 4 == 0
    NQ4 = N // 4
    NW = NQ4 + (MAX_MATCH + 6) // 4 + 1  # overhang past the chunk end

    dlist = union_dominants(d_cand, num_seg, num_dom, D,
                            harvest_stride=harvest_stride, sel=sel, pair=pair)

    # Packed words + phase views (see local_dominant_lengths).
    d8 = jnp.concatenate(
        [jnp.zeros(WINDOW_SIZE, buf.dtype), buf,
         jnp.zeros(4 * NW + 8, buf.dtype)]
    ).astype(jnp.uint32)
    P = d8[:-3] | (d8[1:-2] << 8) | (d8[2:-1] << 16) | (d8[3:] << 24)
    NP = (P.shape[0] - 4) // 4
    phases = jnp.stack([P[r : r + 4 * NP : 4] for r in range(4)])  # [4, NP]
    base = (P[WINDOW_SIZE::4])[:NW]

    # Gather-free collection: one contiguous slice per distance.
    def collect(t, sh_all):
        d = jax.lax.dynamic_index_in_dim(dlist, t, keepdims=False)
        off = WINDOW_SIZE - d
        row = jax.lax.dynamic_slice(phases, [off & 3, off >> 2], [1, NW])
        return jax.lax.dynamic_update_slice(sh_all, row, [t, 0])

    sh_all = jax.lax.fori_loop(
        0, D, collect, jnp.zeros((D, NW), jnp.uint32)
    )

    # Batched compare + packed-prefix run scan + winner, all in word space.
    x = base[None, :] ^ sh_all  # [D, NW]
    mb = _matched_low_bytes(x)
    wi = jnp.arange(NW, dtype=jnp.int32)
    pval = jnp.where(x == 0, jnp.int32(NW * 8), wi[None, :] * 8 + mb)
    pmin = jax.lax.cummin(pval, axis=1, reverse=True)
    run0 = 4 * ((pmin >> 3) - wi[None, :]) + (pmin & 7)
    run0 = jnp.where((dlist > 0)[:, None], run0, -1)

    win = jnp.argmax(run0, axis=0)  # [NW]
    onehot = jnp.arange(D, dtype=jnp.int32)[:, None] == win[None, :]
    run_w = jnp.max(run0, axis=0)
    dist_w = jnp.sum(jnp.where(onehot, dlist[:, None], 0), axis=0)
    # xor of word w at the distance that wins word w+1 (for o>0 claims).
    onehot_n = jnp.concatenate(
        [onehot[:, 1:], jnp.zeros((D, 1), bool)], axis=1
    )
    xor_next = jnp.sum(jnp.where(onehot_n, x, jnp.uint32(0)), axis=0)

    return _finish_from_winner(
        run_w[:NQ4], dist_w[:NQ4], run_w[1 : NQ4 + 1], dist_w[1 : NQ4 + 1],
        xor_next[:NQ4], N, n_total, hstart,
    )


def _select_dominants(d_cand, S: int, M: int, harvest_stride: int = 1,
                      sel: str = "freq", pair: bool = False):
    """Per-segment top-M harvested distances: [S, M], 0 inert.

    Two selection policies (both mask dead slots to 0 and order live
    dominants as a count-descending PREFIX of the row, so a measurement
    loop may stop at the live count; ties prefer the larger distance,
    measured ratio-neutral-to-better):

    ``sel="freq"`` (rounds 3-4): TOTAL frequency per distinct distance —
    an ascending value sort, run-sum over the sorted rows, then a packed
    (freq << 16 | value) descending sort.  TWO [S, LC] sorts.

    ``sel="run"`` (round 5): LONGEST CONTIGUOUS RUN per distance, counted
    directly in position order (capped claims arrive in runs — the same
    observation harvest_stride exploits), so the ONLY [S, LC] sort is the
    packed descending selection; run detection is elementwise scan work.
    A distance split across several runs is ranked by its longest one;
    top-M rows are then deduped (an [S, M, M] compare — M is small) and
    re-compacted with a tiny [S, M] sort to restore the live-prefix
    invariant.  Halves the selection's full-width sort work.  Ratio:
    measured equal-or-better on every in-image corpus at the round-5
    budget.
    """
    if pair:
        # PAIR-COLLAPSE halving (round 5): where a stride-2 subsample DROPS
        # odd-position claims — and the tar_tree contract hinges on a
        # handful of isolated claims (stride 2 re-broke it by 2-5 bytes at
        # every budget tried) — the pair reduction keeps a claim if EITHER
        # position of the pair has one: c = even if even != 0 else odd.
        # Run lengths halve like stride's, singletons survive.  Measured
        # contract-equivalent to the full-width harvest on all nine
        # corpora at half the selection sort's elements.
        assert harvest_stride == 1, "pair collapse replaces the stride"
        dc0 = d_cand.reshape(S, -1)
        even, odd = dc0[:, 0::2], dc0[:, 1::2]
        dc = jnp.where(even != 0, even, odd)
    else:
        dc = d_cand.reshape(S, -1)[:, ::harvest_stride]
    LC = dc.shape[1]
    # The packed (count << 16 | value) selection below needs count < 2^15
    # to stay positive in int32; count <= row width, so an out-of-range
    # config (e.g. dom_segs=1 with stride 1 at N=65536+) must fail loudly
    # here instead of silently mis-ranking dominants (ADVICE r4).  Shapes
    # are static, so this is a trace-time check, not a device op.
    if LC >= (1 << 15):
        raise ValueError(
            f"dominant-selection row width {LC} >= 2^15 overflows the "
            "packed freq<<16 sort; raise dom_segs or harvest_stride"
        )
    rows = dc if sel == "run" else jnp.sort(dc, axis=1)
    ii = jnp.arange(LC, dtype=jnp.int32)[None, :]
    change = jnp.concatenate(
        [jnp.ones((S, 1), bool), rows[:, 1:] != rows[:, :-1]], axis=1
    )
    start = jax.lax.cummax(jnp.where(change, ii, 0), axis=1)
    end = jax.lax.cummin(
        jnp.where(jnp.concatenate([change[:, 1:], jnp.ones((S, 1), bool)], axis=1),
                  ii + 1, LC),
        axis=1, reverse=True,
    )
    freq = jnp.where(change & (rows > 0), end - start, 0)
    packed = (freq << 16) | rows
    top = jax.lax.sort(packed, dimension=1, is_stable=False)[:, ::-1][:, :M]
    if top.shape[1] < M:  # fewer harvest columns than requested dominants
        top = jnp.concatenate(
            [top, jnp.zeros((S, M - top.shape[1]), top.dtype)], axis=1
        )
    if sel == "run":
        # Dedup: a distance with several runs may occupy several top-M
        # slots; keep its highest-ranked slot only, then re-compact so the
        # live dominants stay a prefix.
        v = top & 0xFFFF
        dup = jnp.tril(v[:, :, None] == v[:, None, :], k=-1).any(axis=2)
        top = jnp.where(dup, 0, top)
        top = jax.lax.sort(top, dimension=1, is_stable=False)[:, ::-1]
    topf = top >> 16
    return jnp.where(topf > 0, top & 0xFFFF, 0), topf


def _finish_from_winner(run_q, dist_q, run_n, dist_n, xor_n, N: int,
                        n_total, hstart):
    """O(N) byte expansion of per-word winners into per-position claims.

    Args (all [N//4], word-grid values):
      run_q/dist_q: best word-start run and its distance at word q.
      run_n/dist_n/xor_n: the NEXT word's winner run/distance and THIS
        word's xor under that winner (o>0 claims continue into word q+1).
    """
    idx = jnp.arange(N, dtype=jnp.int32)
    limit = jnp.clip(n_total - idx, 0, MAX_MATCH)
    NQ4 = N // 4

    def up4(a):
        return jnp.broadcast_to(a[:, None], (NQ4, 4)).reshape(N)

    len0 = up4(run_q)
    d0 = up4(dist_q)
    rn = up4(run_n)
    dn = up4(dist_n)
    xq = up4(xor_n)
    o = idx & 3
    sh8 = (o.astype(jnp.uint32) << 3)
    tail = jnp.where(o > 0, xq >> sh8, jnp.uint32(1))
    eo = jnp.minimum(_matched_low_bytes(tail), 4 - o)
    len_o = eo + jnp.where(eo == 4 - o, jnp.maximum(rn, 0), 0)
    b_len = jnp.where(o == 0, jnp.maximum(len0, 0), len_o)
    b_dist = jnp.where(o == 0, d0, dn)

    b_len = jnp.minimum(b_len, limit)
    ok = (b_len >= 3) & (b_dist > 0) & (idx - b_dist >= hstart) & (idx < n_total)
    return jnp.where(ok, b_len, 0), jnp.where(ok, b_dist, 0)


def local_dominant_lengths(buf, N: int, n_total, hstart, d_cand, *,
                           num_dom: int = 8, num_seg: int = 16,
                           harvest_stride: int = 1, sel: str = "freq",
                           pair: bool = False):
    """Per-position match lengths at each SEGMENT's dominant distances.

    Args:
      buf: uint8[N + PAD] chunk buffer (history + payload + padding),
        PAD >= 8.
      N: static number of positions (must divide by 4*num_seg).
      n_total: dynamic end of valid bytes.
      hstart: dynamic first valid position.
      d_cand: int32[k*N] candidate distances (0 = none), position-major so
        entries k*i..k*i+k-1 belong to position i — the distances whose
        claims hit a measurement cap upstream.
      num_dom: distances measured per segment (top-M by frequency).
      num_seg: segment count (segment length = N // num_seg).
      harvest_stride: subsample the candidate rows by this stride before the
        dominant count (capped claims arrive in runs, so a strided sample
        preserves the frequency ranking at 1/stride the sort cost).

    Returns (best_len, best_dist): int32[N], 0 where no claim.
    """
    S = num_seg
    M = num_dom
    assert N % (4 * S) == 0 and d_cand.shape[0] % S == 0
    L = N // S
    # Overhang: runs extend past the segment end by up to MAX_MATCH.
    LW = (L + MAX_MATCH + 6) // 4 + 1

    # ---------------- per-segment top-M candidate distances by frequency
    doms, _ = _select_dominants(d_cand, S, M, harvest_stride, sel=sel,
                                pair=pair)

    # --------------------------- phase-decomposed packed words, word space
    # P[x] = bytes x..x+3 little-endian.  Right-pad so the last segment's
    # overhang and the phase slices stay in bounds (dynamic_slice CLAMPS
    # out-of-bounds starts — a silent misalignment, so pad instead).
    d8 = jnp.concatenate(
        [jnp.zeros(WINDOW_SIZE, buf.dtype), buf,
         jnp.zeros(4 * LW + 8, buf.dtype)]
    ).astype(jnp.uint32)
    P = d8[:-3] | (d8[1:-2] << 8) | (d8[2:-1] << 16) | (d8[3:] << 24)
    # Four phase views: P[r::4][q] == P[4q + r].
    NP = (P.shape[0] - 4) // 4
    phases = jnp.stack([P[r : r + 4 * NP : 4] for r in range(4)])  # [4, NP]
    base_w = (P[WINDOW_SIZE::4])[: N // 4 + LW]  # aligned grid, whole chunk

    wi = jnp.arange(LW, dtype=jnp.int32)

    # Vmapped per-(segment, dominant) shifted slices.  The shifted word row
    # for (s, d) is phases[(W+s*L-d) & 3] at word offset (W+s*L-d) >> 2 —
    # P[x] covers bytes x..x+3, so this is the byte-granular compare
    # evaluated on the segment's 4-aligned grid.
    def seg_rows(s, ds):
        base = jax.lax.dynamic_slice(base_w, [s * (L // 4)], [LW])

        def one(d):
            off = WINDOW_SIZE + s * L - d
            sh = jax.lax.dynamic_slice(phases, [off & 3, off >> 2], [1, LW])[0]
            return base ^ sh

        return jax.vmap(one)(ds)

    xors = jax.vmap(seg_rows)(jnp.arange(S, dtype=jnp.int32), doms)

    # Batched packed-prefix run scan over ALL pairs at once (the batched
    # cummin runs at ~0.15 ns/element; a per-pair scan does not).
    mb = _matched_low_bytes(xors)
    pval = jnp.where(xors == 0, jnp.int32(LW * 8), wi[None, None, :] * 8 + mb)
    pmin = jax.lax.cummin(pval, axis=2, reverse=True)
    run0 = 4 * ((pmin >> 3) - wi[None, None, :]) + (pmin & 7)

    # ------------------------------- word-space winner across dominants
    live = doms > 0  # [S, M]
    run0 = jnp.where(live[:, :, None], run0, -1)
    win = jnp.argmax(run0, axis=1)  # [S, LW]
    onehot = win[:, None, :] == jnp.arange(M, dtype=jnp.int32)[None, :, None]
    run0_win = jnp.max(run0, axis=1)  # [S, LW]
    dist_win = jnp.sum(jnp.where(onehot, doms[:, :, None], 0), axis=1)
    # xor of word w evaluated at w+1's winning dominant (for o>0 claims).
    onehot_n = jnp.concatenate(
        [onehot[:, :, 1:], jnp.zeros((S, M, 1), bool)], axis=2
    )
    xor_next_sel = jnp.sum(jnp.where(onehot_n, xors, jnp.uint32(0)), axis=1)

    # ------------------------------------- O(N) byte expansion (exact)
    # Position i = (s, w, o).  o == 0: the word-start run at its winner.
    # o > 0: match bytes o..3 of word w under the distance that wins word
    # w+1, then continue with run0_win[w+1] — a provable lower bound (see
    # module docstring).  Only claims longer than the upstream probe cap
    # ever take effect, so the o>0 tail-byte choice cannot cost ratio.
    LQ = L // 4
    return _finish_from_winner(
        run0_win[:, :LQ].reshape(-1), dist_win[:, :LQ].reshape(-1),
        run0_win[:, 1 : LQ + 1].reshape(-1), dist_win[:, 1 : LQ + 1].reshape(-1),
        xor_next_sel[:, :LQ].reshape(-1), N, n_total, hstart,
    )
