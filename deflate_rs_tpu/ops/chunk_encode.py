"""The per-chunk DEFLATE encoder: one fused, jittable pipeline.

This is the data-parallel counterpart of the reference's driver loop
(``compress_data_dynamic_n``, compress.rs:80) — but where the reference
processes a sliding window byte-by-byte, this encodes one independent chunk
(up to ``emit_size`` bytes, preceded by up to 32 KiB of history halo) as a
single DEFLATE block chosen among stored/fixed/dynamic by exact bit cost
(mirroring gen_huffman_lengths, huffman_lengths.rs:167-286).

Chunks are byte-aligned: a non-final chunk ends with an empty stored block
(the sync-flush marker ``00 00 FF FF``, compress.rs:257-262), which is what
makes chunks independently encodable and concatenable — the parallel seam the
build plan (SURVEY.md §2) calls for.

Pipeline stages (all fixed-shape, no data-dependent Python control flow;
tokens live in POSITION space end to end — no compaction, no gathers):
  hash -> payload sort -> K-probe -> chain extension -> lazy jump steps
  -> pointer-doubling parse (parse.py) -> per-position
  symbol fields -> one-hot histograms -> package-merge code lengths
  -> header RLE -> exact cost decision -> field list -> sort-compaction
  bit pack (bitpack.py), plus Adler-32/CRC-32 partials over the payload.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants as C
from ..compression_options import CompressionOptions, SpecialOptions
from .bitpack import pack_fields
from .canonical import canonical_codes
from .checksum import adler32_parts_device, crc32_raw_device
from .code_lengths import CL_CAP, encode_code_lengths
from .matching import find_matches, find_matches_hash, find_rle_matches
from .symbolmap import dist_code, histogram_onehot, length_code, table_lookup
from .package_merge import package_merge_rows
from .parse import build_jumps, token_starts

HALO = C.WINDOW_SIZE  # history bytes preceding the emit region
PAD = 72  # tail padding so packed-word probe reads (up to 64 B probes) stay in bounds


def out_words(emit_size: int, force_fixed: bool = True) -> int:
    """Output word-buffer capacity.

    Normal/ForceStored modes never exceed the stored bound (the cost model
    takes min(huffman, stored)): 8 bits/byte + 40 bits per 64 KiB sub-block
    + sync/byte-align slack — just over emit_size/4 words.  ForceFixed can
    legally emit 9 bits/byte (fixed codes for literals 144..255), so it
    needs the 9/8 sizing; callers that know the mode pass force_fixed=False
    to shrink the buffer (and the host fetch) by ~12%.
    """
    if force_fixed:
        return (9 * emit_size) // 32 + 2048
    return emit_size // 4 + (emit_size // C.MAX_STORED_BLOCK + 2) * 2 + 64

# Per-chunk layout: buf[HALO - hist_len : HALO] = history, buf[HALO : HALO+n]
# = payload. The emit region always starts at buffer offset HALO.


from ..utils.tables import dev_const as _const

_DH_BITS = np.array([5, 5, 4], np.int32)
_SH_BITS = np.array([3, 5, 16, 16], np.int32)
_SY_VALS = np.array([0, 0, 0x0000, 0xFFFF], np.uint32)
_SY_BITS = np.array([3, 0, 16, 16], np.int32)

# ---------------------------------------------------------------------------
# Intra-chunk block splitting (the reference re-decides block type and
# rebuilds tables every <=31744 tokens, output_writer.rs:19 +
# compress.rs:186-247).  Here the emit region is cut into NQ quarters at
# STATIC positions; the encoder scores every contiguous quarter range with
# its own optimal tables and picks the cheapest composition of ranges into
# blocks — one block per chunk stays available as composition 0.  Match
# tokens may cross a seam (they belong to the block of their start position,
# and DEFLATE match history is stream-wide), so the parse is unchanged; only
# the entropy coding adapts.
# ---------------------------------------------------------------------------

def _make_compositions(nq: int):
    comps = []
    for mask in range(1 << (nq - 1)):
        bounds = [0] + [b + 1 for b in range(nq - 1) if (mask >> b) & 1] + [nq]
        comps.append(tuple((bounds[t], bounds[t + 1]) for t in range(len(bounds) - 1)))
    comps.sort(key=len)  # argmin picks the FIRST min => fewer blocks on ties
    return comps


class _SplitCfg:
    """Static split machinery for an ``nq``-quarter chunk.

    nq is per-preset (options.num_quarters): throughput presets that opt out
    of splitting get nq=1, collapsing every per-quarter loop below to a
    single whole-chunk iteration (composition 0 is then the only one).
    """

    def __init__(self, nq: int):
        self.nq = nq
        self.ranges = [(i, j) for i in range(nq) for j in range(i + 1, nq + 1)]
        self.range_id = {r: k for k, r in enumerate(self.ranges)}
        comps = self.comps = _make_compositions(nq)
        # Per (quarter, composition) host constants driving the selectors.
        self.hdr_start = np.array(
            [[int(any(r[0] == q for r in c)) for c in comps] for q in range(nq)], np.int32
        )
        self.blk_end = np.array(
            [[int(any(r[1] == q + 1 for r in c)) for c in comps] for q in range(nq)], np.int32
        )
        self.last_start = np.array([max(r[0] for r in c) for c in comps], np.int32)
        # Block-slot machinery: composition c's t-th block is its t-th range;
        # the exact tables are built only for these <= nq slots.
        self.slotq = np.array(
            [[next(t for t, r in enumerate(c) if r[0] <= q < r[1]) for c in comps]
             for q in range(nq)],
            np.int32,
        )  # [q][comp] -> slot index owning quarter q
        self.mem = np.array(
            [[[1 if (t < len(c) and c[t][0] <= q < c[t][1]) else 0 for c in comps]
              for q in range(nq)] for t in range(nq)],
            np.int32,
        )  # [t][q][comp] -> quarter q in slot t
        self.exist = np.array(
            [[1 if t < len(c) else 0 for c in comps] for t in range(nq)], np.int32
        )
        self.rid_t = np.array(
            [[self.range_id[c[t]] if t < len(c) else 0 for c in comps] for t in range(nq)],
            np.int32,
        )  # [t][comp] -> range id of the t-th block (exact-scoring reuse)
        self.comp_ranges = np.array(
            [[1 if r in c else 0 for r in self.ranges] for c in comps], np.int32
        )  # [comp][range] membership — composition cost as ONE matvec


@functools.lru_cache(maxsize=None)
def _split_cfg(nq: int) -> _SplitCfg:
    return _SplitCfg(nq)


def hash_matches(buf, N: int, n_total, hstart, options: CompressionOptions):
    """The main matcher's per-position (best_len, best_dist) for the
    chain-budget presets (matcher_mode "hash"), before long-range recovery."""
    if options.matcher_algo == "sa":
        return find_matches(
            buf, N, n_total, hstart, options.num_candidates,
            probe_words=options.probe_words, nkey=options.resolved_sort_nkey,
            tail_jumps=options.resolved_sa_tail,
        )
    return find_matches_hash(
        buf, N, n_total, hstart, options.num_candidates,
        probe_words=options.probe_words,
    )


def dominant_lengths(buf, N: int, n_total, hstart, d_cand, options: CompressionOptions):
    """One round of the long-range pass (ops/longrange.py) at the options'
    budget: exact lengths at the dominant harvested distances."""
    from .longrange import global_dominant_lengths, local_dominant_lengths

    kw = dict(
        num_dom=options.resolved_num_dom, num_seg=options.resolved_dom_segs,
        harvest_stride=options.resolved_lr_stride, sel=options.resolved_lr_sel,
        pair=options.resolved_lr_pair,
    )
    if options.lr_global:
        return global_dominant_lengths(
            buf, N, n_total, hstart, d_cand, num_global=options.lr_global, **kw
        )
    return local_dominant_lengths(buf, N, n_total, hstart, d_cand, **kw)


def jump_steps(best_len, best_dist, options: CompressionOptions):
    """Jump steps over the emit region: 1 for a literal, match length for a
    taken match (greedy/lazy resolved elementwise in build_jumps)."""
    return build_jumps(
        best_len[HALO:],
        best_dist[HALO:],
        lazy=options.lazy,
        lazy_if_less_than=min(options.lazy_if_less_than, 258) if options.lazy else 0,
    )


def encode_chunk(buf, hist_len, n, is_last, *, emit_size: int, options: CompressionOptions,
                 with_checksums: bool = True, stored_payload_fields: bool = True):
    """Encode one chunk. See module docstring for the layout.

    Args:
      buf: uint8[HALO + emit_size + PAD].
      hist_len: dynamic history length (0 for the first chunk of a stream).
      n: dynamic payload length, 0 <= n <= emit_size.
      is_last: bool scalar — set BFINAL and omit the trailing sync marker.
      emit_size: static chunk capacity (power of two).
      options: static compression options.
      with_checksums: compute Adler-32/CRC-32 partials on device.  The
        sharded pipeline wants them (host may never touch payload bytes);
        host-driven paths skip them and use the native C checksums instead
        (runtime/native.py), since the host holds the bytes anyway.
      stored_payload_fields: emit the stored sub-block fields into the
        packed words.  The COMPACTED consumers (corpus flat mode, sharded
        compact mode) never read a stored chunk's device words (used = 0;
        the host re-emits stored chunks from the raw payload), so they pass
        False and drop E/4 fields from every chunk's bit pack — ~11% of the
        pack's sort rows.  total_bits/data_bits stay exact either way (the
        stored size comes from the cost model, not the pack).

    Returns dict with the packed bitstream words, total bit count, chosen
    block type, token count, and (if requested) checksum partials.
    """
    E = emit_size
    N = HALO + E
    is_last = jnp.asarray(is_last, dtype=jnp.bool_)
    n = jnp.asarray(n, dtype=jnp.int32)
    hist_len = jnp.asarray(hist_len, dtype=jnp.int32)
    n_total = HALO + n
    hstart = HALO - hist_len
    sc = _split_cfg(options.num_quarters)
    # Quarter slices (histograms, token field segments) require exact
    # division; a non-divisor nq would silently drop tail-position fields
    # and emit a corrupt stream, so fail loudly (reachable only through the
    # numeric block_split override).
    assert E % sc.nq == 0, (E, sc.nq, "emit_size must divide by num_quarters")

    # ------------------------------------------------------------------ LZ77
    mode = options.matcher_mode
    if mode == "hash":
        best_len, best_dist = hash_matches(buf, N, n_total, hstart, options)
        if options.use_long_range:
            # Long-range recovery (ops/longrange.py): positions whose claim
            # hit the probe cap contribute their distance; per-segment
            # dominant distances are then measured EXACTLY at every
            # position, recovering full-length matches where probe-capped
            # tie diversity fragmented them.  (An earlier content-defined
            # anchor matcher fed this too — measured to add nothing once
            # the harvest came from the main matcher's capped claims, and
            # deleted.)
            from .matching import chain_extend, stride_extend

            cap = 4 * options.probe_words
            d_cand = jnp.where(best_len >= cap, best_dist, 0)
            lim_n = jnp.clip(n_total - jnp.arange(N, dtype=jnp.int32), 0, C.MAX_MATCH)
            for _ in range(options.resolved_dom_iters):
                g_len, g_dist = dominant_lengths(buf, N, n_total, hstart, d_cand, options)
                take = g_len > best_len
                best_len = jnp.where(take, g_len, best_len)
                best_dist = jnp.where(take, g_dist, best_dist)
                # Next round harvests the claims whose length is STILL
                # unmeasured (>= cap): those are the only ones whose true
                # extent a further exact pass can reveal; short resolved
                # matches would just dilute the per-segment top-M.
                d_cand = jnp.where(best_len >= cap, best_dist, 0)
            best_len = stride_extend(
                chain_extend(best_len, best_dist, lim_n, N), best_dist, lim_n
            )
            ok3 = best_len >= C.MIN_MATCH
            best_len = jnp.where(ok3, best_len, 0)
            best_dist = jnp.where(ok3, best_dist, 0)
    elif mode == "rle":
        best_len, best_dist = find_rle_matches(buf, n_total, hstart, N)
    else:  # huffman_only
        best_len = jnp.zeros(N, dtype=jnp.int32)
        best_dist = jnp.zeros(N, dtype=jnp.int32)

    # ------------------------------------------------------ parse resolution
    # Tokens stay in POSITION space end to end (no compaction): the parse
    # yields a boolean token-start mask; every downstream stage masks by it.
    steps = jump_steps(best_len, best_dist, options)
    is_tok = token_starts(steps, n)
    count = jnp.sum(is_tok.astype(jnp.int32))
    tvalid = is_tok

    # ------------------------- token symbol mapping (arithmetic, gather-free)
    length = steps
    dist = jnp.where(steps >= C.MIN_MATCH, best_dist[HALO:], 0)
    is_match = length >= C.MIN_MATCH
    lit = buf[HALO : HALO + E].astype(jnp.int32)

    lcode, len_extra_n, len_extra_v = length_code(jnp.clip(length, C.MIN_MATCH, C.MAX_MATCH))
    len_extra_n = jnp.where(is_match, len_extra_n, 0)
    len_extra_v = jnp.where(is_match, len_extra_v, 0)
    lsym = jnp.where(is_match, 257 + lcode, lit)
    dcode, dist_extra_n, dist_extra_v = dist_code(jnp.clip(dist, 1, C.WINDOW_SIZE))
    dcode = jnp.where(is_match, dcode, 0)
    dist_extra_n = jnp.where(is_match, dist_extra_n, 0)
    dist_extra_v = jnp.where(is_match, dist_extra_v, 0)

    QL = E // sc.nq

    # Per-quarter histograms over STATIC position slices (same total one-hot
    # work as one whole-chunk histogram), then prefix sums give every quarter
    # range its histogram.  Each range gets its own EOB.
    lf_q = jnp.stack([
        histogram_onehot(lsym[q * QL : (q + 1) * QL], tvalid[q * QL : (q + 1) * QL], C.NUM_USED_LITLEN)
        for q in range(sc.nq)
    ])
    df_q = jnp.stack([
        histogram_onehot(
            dcode[q * QL : (q + 1) * QL], (tvalid & is_match)[q * QL : (q + 1) * QL], C.NUM_DIST_SYMBOLS
        )
        for q in range(sc.nq)
    ])
    lf_cum = jnp.concatenate([jnp.zeros((1, C.NUM_USED_LITLEN), jnp.int32), jnp.cumsum(lf_q, axis=0)])
    df_cum = jnp.concatenate([jnp.zeros((1, C.NUM_DIST_SYMBOLS), jnp.int32), jnp.cumsum(df_q, axis=0)])
    l_freq_r = jnp.stack([lf_cum[j] - lf_cum[i] for (i, j) in sc.ranges])  # [R, 286]
    d_freq_r = jnp.stack([df_cum[j] - df_cum[i] for (i, j) in sc.ranges])  # [R, 30]
    l_freq_r = l_freq_r.at[:, C.END_OF_BLOCK].add(1)

    # ------------------- composition scoring (entropy proxy, exact fixed)
    # The round-1 encoder ran exact package-merge + header RLE for ALL 10
    # contiguous quarter ranges just to score the 8 compositions — the
    # 15-level package-merge chain was the largest cost of that design.
    # Compositions are now scored with a Shannon-entropy proxy for the
    # dynamic cost (optimal length-limited codes track ceil(-log2 p) very
    # closely) plus the EXACT fixed cost; exact tables and bit costs are
    # then built only for the chosen composition's <= NQ blocks, so the
    # emitted size and every downstream decision (fixed/dynamic/stored)
    # remain exact.  Only the split choice itself is heuristic, and any
    # choice yields a valid stream (same argument as huffman_lengths.rs
    # block-type choice being a pure size optimization).
    l_extra_tbl = jnp.concatenate(
        [jnp.zeros(257, jnp.int32), _const(C.LENGTH_EXTRA_BITS)]
    )
    d_extra_tbl = _const(C.DIST_EXTRA_BITS)
    fixed_l_len286 = _const(C.FIXED_LITLEN_LENGTHS[: C.NUM_USED_LITLEN])
    fixed_d_len = _const(C.FIXED_DIST_LENGTHS)

    def _proxy_bits(freq_r):
        """(entropy token bits, used symbols, zero-run starts) per range."""
        tot = jnp.sum(freq_r, axis=1, keepdims=True).astype(jnp.float32)
        f = freq_r.astype(jnp.float32)
        lens = jnp.clip(
            jnp.ceil(jnp.log2(jnp.maximum(tot, 1.0)) - jnp.log2(jnp.maximum(f, 1.0))),
            1.0, float(C.MAX_CODE_LENGTH),
        )
        bits = jnp.sum(jnp.where(freq_r > 0, f * lens, 0.0), axis=1)
        used = freq_r > 0
        u = jnp.sum(used, axis=1)
        prev = jnp.concatenate([jnp.zeros((freq_r.shape[0], 1), bool), used[:, :-1]], axis=1)
        z = jnp.sum(prev & ~used, axis=1)
        return bits.astype(jnp.int32), u.astype(jnp.int32), z.astype(jnp.int32)

    lbits_p, lu, lz = _proxy_bits(l_freq_r)
    dbits_p, du, dz = _proxy_bits(d_freq_r)
    extra_bits_r = jnp.sum(l_freq_r * l_extra_tbl[None, :], axis=1) + jnp.sum(
        d_freq_r * d_extra_tbl[None, :], axis=1
    )
    fix_tok_bits_r = jnp.sum(l_freq_r * (fixed_l_len286 + l_extra_tbl)[None, :], axis=1) + jnp.sum(
        d_freq_r * (fixed_d_len + d_extra_tbl)[None, :], axis=1
    )
    # Header proxy: HLIT/HDIST/HCLEN + ~19 clen slots + ~4 bits per used
    # symbol + ~8 bits per zero run in the length array.
    proxy_hdr_r = 14 + 57 + 4 * (lu + du) + 8 * (lz + dz)
    pm15 = functools.partial(package_merge_rows, max_len=C.MAX_CODE_LENGTH)
    R_ = len(sc.ranges)
    if options.exact_split_scoring:
        # High preset: exact optimal token bits for every range (the full
        # 15-level package-merge over all 2R rows); the chosen blocks then
        # reuse these per-range tables instead of re-running package-merge.
        d_freq_pad_r = jnp.concatenate(
            [d_freq_r, jnp.zeros((R_, C.NUM_USED_LITLEN - C.NUM_DIST_SYMBOLS), jnp.int32)],
            axis=1,
        )
        ld_len_r = pm15(jnp.concatenate([l_freq_r, d_freq_pad_r], axis=0))
        l_len_r286 = ld_len_r[:R_]
        d_len_r = ld_len_r[R_:, : C.NUM_DIST_SYMBOLS]
        dyn_tok_bits_r = jnp.sum(
            l_freq_r * (l_len_r286 + l_extra_tbl[None, :]), axis=1
        ) + jnp.sum(d_freq_r * (d_len_r + d_extra_tbl[None, :]), axis=1)
        # Exact header bits as well (RLE + clen codes per range): the whole
        # point of this preset is exact scoring, and it is cheap next to the
        # 2R-row package-merge above.
        hlit_x = jnp.clip(
            jnp.max(jnp.where(l_len_r286 > 0, jnp.arange(C.NUM_USED_LITLEN)[None, :], -1), axis=1)
            + 1,
            C.MIN_NUM_LITLEN_CODES, C.NUM_USED_LITLEN,
        )
        hdist_x = jnp.clip(
            jnp.max(jnp.where(d_len_r > 0, jnp.arange(C.NUM_DIST_SYMBOLS)[None, :], -1), axis=1)
            + 1,
            C.MIN_NUM_DIST_CODES, C.NUM_DIST_SYMBOLS,
        )
        jx = jnp.arange(CL_CAP, dtype=jnp.int32)
        cl_x = jnp.where(
            jx[None, :] < hlit_x[:, None],
            jnp.take_along_axis(
                l_len_r286,
                jnp.broadcast_to(jnp.clip(jx, 0, C.NUM_USED_LITLEN - 1), (R_, CL_CAP)),
                axis=1,
            ),
            jnp.take_along_axis(
                d_len_r, jnp.clip(jx[None, :] - hlit_x[:, None], 0, C.NUM_DIST_SYMBOLS - 1), axis=1
            ),
        )
        rle_x = jax.vmap(encode_code_lengths)(cl_x, hlit_x + hdist_x)
        clen_len_x = package_merge_rows(
            rle_x["freq"], max_len=C.MAX_CLEN_CODE_LENGTH
        )
        hclen_x = jnp.clip(
            jnp.max(
                jnp.where(clen_len_x[:, C.CLEN_ORDER] > 0, jnp.arange(19)[None, :], -1), axis=1
            )
            + 1,
            4, 19,
        )
        rle_used_x = jnp.arange(CL_CAP)[None, :] < rle_x["n"][:, None]
        hdr_bits_x = (
            14
            + 3 * hclen_x
            + jnp.sum(
                jnp.where(rle_used_x, jnp.take_along_axis(clen_len_x, rle_x["sym"], axis=1), 0),
                axis=1,
            )
            + jnp.sum(rle_x["extra_bits"], axis=1)
        )
        dyn_score_r = 3 + hdr_bits_x + dyn_tok_bits_r
    else:
        dyn_score_r = 3 + proxy_hdr_r + lbits_p + dbits_p + extra_bits_r
    fix_total_r = 3 + fix_tok_bits_r
    range_score = jnp.minimum(dyn_score_r, fix_total_r)

    force_fix = n <= 4
    if options.special == SpecialOptions.ForceFixed:
        force_fix = True

    # Composition search: cheapest grouping of quarters into blocks.  sc.comps
    # is sorted by block count, and argmin takes the first minimum, so equal
    # score prefers fewer blocks (degenerating to one whole-chunk block).
    comp_cost = jnp.tensordot(_const(sc.comp_ranges), range_score, axes=[[1], [0]])
    comp_cost = jnp.where(
        force_fix, jnp.where(jnp.arange(len(sc.comps)) == 0, comp_cost, jnp.int32(1 << 30)), comp_cost
    )
    best_comp = jnp.argmin(comp_cost).astype(jnp.int32)
    comp_onehot = (jnp.arange(len(sc.comps)) == best_comp).astype(jnp.int32)
    is_split = best_comp != 0

    # ------------- exact Huffman tables for the chosen blocks (<= NQ slots)
    exist = jnp.tensordot(_const(sc.exist), comp_onehot, axes=[[1], [0]])  # [t]
    NS = sc.nq
    if options.exact_split_scoring:
        # Slot tables, headers AND bit costs are row-selections of the
        # per-range results already computed for scoring — no table or
        # header work is redone for the chosen blocks (nonexistent slots
        # select range 0: inert, every use is gated by ``exist`` or the
        # quarter selectors).
        rid_t = jnp.tensordot(_const(sc.rid_t), comp_onehot, axes=[[1], [0]])
        l_freq_s = l_freq_r[rid_t]
        d_freq_s = d_freq_r[rid_t]
        l_len_s286 = l_len_r286[rid_t]
        d_len_s = d_len_r[rid_t]
        hlit_s = hlit_x[rid_t]
        hdist_s = hdist_x[rid_t]
        rle_s = {k: v[rid_t] for k, v in rle_x.items()}
        clen_len_s = clen_len_x[rid_t]
        hclen_s = hclen_x[rid_t]
        dyn_tok_bits_s = dyn_tok_bits_r[rid_t]
        fix_tok_bits_s = fix_tok_bits_r[rid_t]
        dyn_hdr_bits_s = hdr_bits_x[rid_t]  # same 14 + 3*hclen + clen formula
    else:
        mem = jnp.tensordot(_const(sc.mem), comp_onehot, axes=[[2], [0]])  # [t, q]
        l_freq_s = jnp.einsum("tq,qa->ta", mem, lf_q).at[:, C.END_OF_BLOCK].add(exist)
        d_freq_s = jnp.einsum("tq,qa->ta", mem, df_q)

        # One batched package-merge for BOTH alphabets: the dist histograms
        # ride padded to the litlen width (zero-frequency symbols are inert
        # in package-merge), so one 15-level chain serves both.
        d_freq_pad = jnp.concatenate(
            [d_freq_s, jnp.zeros((NS, C.NUM_USED_LITLEN - C.NUM_DIST_SYMBOLS), jnp.int32)],
            axis=1,
        )
        ld_len = pm15(jnp.concatenate([l_freq_s, d_freq_pad], axis=0))
        l_len_s286 = ld_len[:NS]  # [NS, 286]
        d_len_s = ld_len[NS:, : C.NUM_DIST_SYMBOLS]  # [NS, 30]

        sym_l = jnp.arange(C.NUM_USED_LITLEN)
        hlit_s = jnp.clip(
            jnp.max(jnp.where(l_len_s286 > 0, sym_l[None, :], -1), axis=1) + 1,
            C.MIN_NUM_LITLEN_CODES, C.NUM_USED_LITLEN,
        )
        sym_d = jnp.arange(C.NUM_DIST_SYMBOLS)
        hdist_s = jnp.clip(
            jnp.max(jnp.where(d_len_s > 0, sym_d[None, :], -1), axis=1) + 1,
            C.MIN_NUM_DIST_CODES, C.NUM_DIST_SYMBOLS,
        )

        # Concatenated litlen+dist lengths, RLE encoded per slot header.
        j = jnp.arange(CL_CAP, dtype=jnp.int32)
        cl_s = jnp.where(
            j[None, :] < hlit_s[:, None],
            jnp.take_along_axis(
                l_len_s286,
                jnp.broadcast_to(jnp.clip(j, 0, C.NUM_USED_LITLEN - 1), (NS, CL_CAP)),
                axis=1,
            ),
            jnp.take_along_axis(
                d_len_s, jnp.clip(j[None, :] - hlit_s[:, None], 0, C.NUM_DIST_SYMBOLS - 1), axis=1
            ),
        )
        rle_s = jax.vmap(encode_code_lengths)(cl_s, hlit_s + hdist_s)
        clen_len_s = package_merge_rows(
            rle_s["freq"], max_len=C.MAX_CLEN_CODE_LENGTH
        )  # [NS, 19]
        hclen_s = jnp.clip(
            jnp.max(
                jnp.where(clen_len_s[:, C.CLEN_ORDER] > 0, jnp.arange(19)[None, :], -1), axis=1
            )
            + 1,
            4, 19,
        )

        # ----------------------------------- exact bit costs, chosen blocks
        dyn_tok_bits_s = jnp.sum(
            l_freq_s * (l_len_s286 + l_extra_tbl[None, :]), axis=1
        ) + jnp.sum(d_freq_s * (d_len_s + d_extra_tbl[None, :]), axis=1)
        fix_tok_bits_s = jnp.sum(
            l_freq_s * (fixed_l_len286 + l_extra_tbl)[None, :], axis=1
        ) + jnp.sum(d_freq_s * (fixed_d_len + d_extra_tbl)[None, :], axis=1)
        rle_used_s = jnp.arange(CL_CAP)[None, :] < rle_s["n"][:, None]
        rle_sym_clen_s = jnp.take_along_axis(clen_len_s, rle_s["sym"], axis=1)
        dyn_hdr_bits_s = (
            14
            + 3 * hclen_s
            + jnp.sum(jnp.where(rle_used_s, rle_sym_clen_s, 0), axis=1)
            + jnp.sum(rle_s["extra_bits"], axis=1)
        )

    clen_codes_s = jax.vmap(functools.partial(canonical_codes, max_len=C.MAX_CLEN_CODE_LENGTH))(
        clen_len_s
    )
    clen_in_order_s = clen_len_s[:, C.CLEN_ORDER]  # host-const column gather

    n_sub_static = max(1, (E + C.MAX_STORED_BLOCK - 1) // C.MAX_STORED_BLOCK)
    sub_k = jnp.arange(n_sub_static, dtype=jnp.int32)
    sub_present = (n > sub_k * C.MAX_STORED_BLOCK) | (sub_k == 0)
    n_sub = jnp.sum(sub_present.astype(jnp.int32))
    stored_bits = 40 * n_sub + 8 * n

    dyn_total_s = 3 + dyn_hdr_bits_s + dyn_tok_bits_s
    fix_total_s = 3 + fix_tok_bits_s
    # Per-block type: fixed beats dynamic on ties (the reference's order,
    # gen_huffman_lengths huffman_lengths.rs:271-286); tiny payloads and
    # ForceFixed pin fixed tables everywhere.
    s_is_fix = (fix_total_s <= dyn_total_s) | force_fix
    slot_cost = jnp.where(s_is_fix, fix_total_s, dyn_total_s)
    huff_total = jnp.sum(exist * slot_cost)
    whole_fix = s_is_fix[0]  # composition 0's only slot is the whole chunk

    # Chunk-level choice vs stored, preserving the reference's tie order
    # (fixed beats stored beats dynamic).
    use_stored = (stored_bits < huff_total) | (
        (stored_bits == huff_total) & ~(~is_split & whole_fix)
    )
    use_stored = use_stored & jnp.logical_not(force_fix)
    if options.special == SpecialOptions.ForceStored:
        use_stored = jnp.full((), True, jnp.bool_)
    is_stored = use_stored
    huff = ~is_stored

    data_bits = jnp.where(is_stored, stored_bits, huff_total).astype(jnp.int32)
    btype = jnp.where(
        is_stored,
        C.BTYPE_STORED,
        jnp.where(
            is_split, C.BTYPE_SPLIT, jnp.where(whole_fix, C.BTYPE_FIXED, C.BTYPE_DYNAMIC)
        ),
    ).astype(jnp.int32)

    # --------------------------------------------------------- field arrays
    # Selected per-slot tables (dynamic padded to 288 symbols).
    l_len_sel_s = jnp.where(
        s_is_fix[:, None],
        _const(C.FIXED_LITLEN_LENGTHS)[None, :],
        jnp.concatenate([l_len_s286, jnp.zeros((NS, 2), jnp.int32)], axis=1),
    )
    d_len_sel_s = jnp.where(s_is_fix[:, None], fixed_d_len[None, :], d_len_s)
    # Batched canonical-code construction for both alphabets (zero-length
    # padding symbols receive no codes, so the dist rows ride padded).
    d_len_sel_pad = jnp.concatenate(
        [d_len_sel_s, jnp.zeros((NS, C.NUM_LITLEN_SYMBOLS - C.NUM_DIST_SYMBOLS), jnp.int32)],
        axis=1,
    )
    ld_codes = jax.vmap(functools.partial(canonical_codes, max_len=C.MAX_CODE_LENGTH))(
        jnp.concatenate([l_len_sel_s, d_len_sel_pad], axis=0)
    )
    l_code_sel_s = ld_codes[:NS]
    d_code_sel_s = ld_codes[NS:, : C.NUM_DIST_SYMBOLS]
    l_pack_s = (l_code_sel_s | (l_len_sel_s.astype(jnp.uint32) << 16)).astype(jnp.int32)
    d_pack_s = (d_code_sel_s | (d_len_sel_s.astype(jnp.uint32) << 16)).astype(jnp.int32)

    # Per-quarter dynamic selectors from the chosen composition.
    hdr_on_q = [jnp.sum(comp_onehot * _const(sc.hdr_start[q])) == 1 for q in range(sc.nq)]
    eob_on_q = [jnp.sum(comp_onehot * _const(sc.blk_end[q])) == 1 for q in range(sc.nq)]
    sid_q = [jnp.sum(comp_onehot * _const(sc.slotq[q])) for q in range(sc.nq)]
    q_last = jnp.sum(comp_onehot * _const(sc.last_start))

    bfinal = jnp.asarray(is_last).astype(jnp.int32)

    seg_v, seg_b = [], []
    for q in range(sc.nq):
        r = sid_q[q]
        part_fix = s_is_fix[r]
        hdr_on = huff & hdr_on_q[q]
        dyn_on = hdr_on & ~part_fix

        # Block header: BFINAL only on the last block of the last chunk.
        bt_bits = jnp.where(part_fix, C.BTYPE_FIXED, C.BTYPE_DYNAMIC).astype(jnp.uint32)
        bf = jnp.where(q == q_last, bfinal, 0).astype(jnp.uint32)
        hdr_v = (bf | (bt_bits << 1))[None]
        hdr_b = jnp.where(hdr_on, 3, 0).astype(jnp.int32)[None]

        # Dynamic header: HLIT/HDIST/HCLEN + clen lengths + RLE symbols.
        hlit = hlit_s[r]
        dh_v = jnp.stack([
            (hlit - 257).astype(jnp.uint32),
            (hdist_s[r] - 1).astype(jnp.uint32),
            (hclen_s[r] - 4).astype(jnp.uint32),
        ])
        dh_b = jnp.where(dyn_on, _const(_DH_BITS), 0)
        co_v = clen_in_order_s[r].astype(jnp.uint32)
        co_b = jnp.where(dyn_on & (jnp.arange(19) < hclen_s[r]), 3, 0)
        rle_sym = rle_s["sym"][r]
        rle_code_v = clen_codes_s[r][rle_sym]
        rle_code_b = jnp.where((jnp.arange(CL_CAP) < rle_s["n"][r]) & dyn_on, clen_len_s[r][rle_sym], 0)
        rle_ex_v = rle_s["extra_vals"][r].astype(jnp.uint32)
        rle_ex_b = jnp.where(dyn_on, rle_s["extra_bits"][r], 0)
        rle_v = jnp.stack([rle_code_v, rle_ex_v], axis=1).reshape(-1)
        rle_b = jnp.stack([rle_code_b, rle_ex_b], axis=1).reshape(-1)

        # Token fields for this quarter's static position slice, coded with
        # the owning block's tables: packed code|len<<16 lookups per side.
        sl = slice(q * QL, (q + 1) * QL)
        tok_on = tvalid[sl] & huff
        l_pack = table_lookup(l_pack_s[r], lsym[sl], C.NUM_LITLEN_SYMBOLS)
        lsym_code = (l_pack & 0xFFFF).astype(jnp.uint32)
        lsym_len = l_pack >> 16
        t1v = lsym_code | (len_extra_v[sl].astype(jnp.uint32) << lsym_len.astype(jnp.uint32))
        t1b = jnp.where(tok_on, lsym_len + len_extra_n[sl], 0)
        mt = tok_on & is_match[sl]
        d_pack = table_lookup(d_pack_s[r], dcode[sl], C.NUM_DIST_SYMBOLS)
        d_code_v = (d_pack & 0xFFFF).astype(jnp.uint32)
        d_code_l = d_pack >> 16
        t2v = d_code_v | (dist_extra_v[sl].astype(jnp.uint32) << d_code_l.astype(jnp.uint32))
        t2b = jnp.where(mt, d_code_l + dist_extra_n[sl], 0)
        tok_v = jnp.stack([t1v, t2v], axis=1).reshape(-1)
        tok_b = jnp.stack([t1b, t2b], axis=1).reshape(-1)

        # End of block (code of the block that closes after this quarter).
        eob_v = l_code_sel_s[r, C.END_OF_BLOCK][None]
        eob_b = jnp.where(huff & eob_on_q[q], l_len_sel_s[r, C.END_OF_BLOCK], 0)[None]

        seg_v += [hdr_v, dh_v, co_v, rle_v, tok_v, eob_v]
        seg_b += [hdr_b, dh_b, co_b, rle_b, tok_b, eob_b]

    # [4] stored sub-blocks: hdr(3) + pad(5) + LEN + NLEN + payload, the
    # payload as 32-bit packed-word fields (4 bytes per field, ragged tail
    # expressed through the field width).
    SB = C.MAX_STORED_BLOCK
    sub_len = jnp.clip(n - sub_k * SB, 0, SB)
    last_sub = jnp.maximum(n_sub - 1, 0)
    sub_final = (sub_k == last_sub) & is_last
    st_segments_v, st_segments_b = [], []
    if stored_payload_fields:
        p = buf[HALO : HALO + E].astype(jnp.uint32)
        pwords = p[0::4] | (p[1::4] << 8) | (p[2::4] << 16) | (p[3::4] << 24)
        wj = jnp.arange(E // 4, dtype=jnp.int32)
        for k in range(n_sub_static):
            on = is_stored & sub_present[k]
            sh_v = jnp.stack(
                [
                    sub_final[k].astype(jnp.uint32),  # hdr: BFINAL | (00 << 1)
                    jnp.zeros((), jnp.uint32),  # pad to byte
                    sub_len[k].astype(jnp.uint32),  # LEN
                    (~sub_len[k]).astype(jnp.uint32) & 0xFFFF,  # NLEN
                ]
            )
            sh_b = jnp.where(on, _const(_SH_BITS), 0)
            lo, hi = k * SB // 4, min((k + 1) * SB, E) // 4
            pb_v = pwords[lo:hi]
            pb_b = jnp.where(on, 8 * jnp.clip(n - 4 * wj[lo:hi], 0, 4), 0)
            st_segments_v += [sh_v, pb_v]
            st_segments_b += [sh_b, pb_b]

    # [5] sync-flush marker for non-final chunks (empty stored block,
    # compress.rs:257-262): header 000, pad to byte, 0x0000, 0xFFFF.
    sync_on = ~is_last
    sync_pad = (-(data_bits + 3)) % 8
    sy_v = _const(_SY_VALS)
    sy_b = jnp.where(
        sync_on,
        jnp.stack(
            [jnp.full((), 3, jnp.int32), sync_pad, jnp.full((), 16, jnp.int32), jnp.full((), 16, jnp.int32)]
        ),
        0,
    )

    values = jnp.concatenate(seg_v + st_segments_v + [sy_v])
    nbits = jnp.concatenate(seg_b + st_segments_b + [sy_b])

    # Sized for the worst *legal* output of the active mode (see out_words).
    num_words = out_words(E, force_fixed=options.special == SpecialOptions.ForceFixed)
    words, total_bits = pack_fields(values, nbits, num_words)
    if not stored_payload_fields:
        # Stored chunks emitted no fields (their words are never read by the
        # compacted consumers); their exact size comes from the cost model —
        # the same data_bits + sync invariant the packed total satisfies for
        # Huffman chunks.
        sync_bits = jnp.where(is_last, 0, 3 + sync_pad + 32)
        total_bits = jnp.where(
            is_stored, (data_bits + sync_bits).astype(total_bits.dtype),
            total_bits,
        )

    out = {
        "words": words,
        "total_bits": total_bits,
        "data_bits": data_bits,
        "btype": btype,
        "ntokens": count,
    }
    if with_checksums:
        s1, s2 = adler32_parts_device(buf[HALO : HALO + E], n)
        out["s1"] = s1
        out["s2"] = s2
        out["crc_raw"] = crc32_raw_device(buf[HALO : HALO + E], n)
    return out


@functools.lru_cache(maxsize=None)
def get_chunk_encoder(options: CompressionOptions, emit_size: int,
                      with_checksums: bool = True):
    """Jitted single-chunk encoder, cached per (options, size) config."""

    fn = functools.partial(
        encode_chunk, emit_size=emit_size, options=options,
        with_checksums=with_checksums,
    )
    return jax.jit(fn)


@functools.lru_cache(maxsize=None)
def get_batch_encoder(options: CompressionOptions, emit_size: int,
                      with_checksums: bool = True):
    """Jitted batched (vmapped over chunks) encoder."""

    fn = functools.partial(
        encode_chunk, emit_size=emit_size, options=options,
        with_checksums=with_checksums,
    )
    return jax.jit(jax.vmap(fn))
