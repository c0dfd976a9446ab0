"""Device-side DEFLATE decoder (the on-device inflate validator).

The BASELINE north star ends with an on-device inflate decoder that
validates the roundtrip; the reference itself ships no decoder (it leans on miniz_oxide,
test_utils.rs:23-72).  This module decodes arbitrary raw-DEFLATE streams with
the DEVICE doing all decoding math; the host only sequences blocks (one
jitted call per DEFLATE block, scalar state between calls).

Huffman decoding is a bit-serial chain in the reference decoders; the
data-parallel formulation decodes SPECULATIVELY AT EVERY BIT OFFSET of the block window:

1. per bit b, accumulate the MSB-first code value level by level (15 shifted
   rows) against the block's canonical (first_code, count, offset) tables —
   every bit learns "if a litlen code started here: symbol, length";
2. length/distance extra bits and the distance code are resolved with
   window gathers at b + codelen (the per-bit tables make any offset legal);
3. the true token sequence is the orbit of the block's first token bit under
   ``step[b]`` (bits consumed by the token at b) — the same jump-graph orbit
   the encoder's parse uses (ops/parse.reachable), so one log-depth pointer
   doubling replaces the serial walk;
4. LZ77 back-references are resolved AFTER all blocks, in one log-depth
   source-pointer-doubling chase over the output buffer (a match byte's
   source chain always terminates at a literal).

All shapes are static per (stream capacity, output capacity) tier; values
< 2**31 throughout.  This is a VALIDATOR: correctness and device residency
are the contract, not throughput.

Reference semantics validated against: RFC 1951 §3.2.5-3.2.7 and the host
oracle (models/inflate.py); also decodes stdlib-zlib-produced streams
(tests/test_inflate_device.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants as C
from ..utils.tables import dev_const as _const
from .parse import reachable
from .symbolmap import table_lookup

_BIGPOS = 1 << 29


# ---------------------------------------------------------------------------
# Canonical decode tables from code lengths (vector, per block)
# ---------------------------------------------------------------------------


def _decode_tables(lengths, max_len: int):
    """(first_code, count, offset, sym_sorted) for one alphabet.

    sym_sorted lists symbols ordered by (code length, symbol) — the canonical
    order — so a decoded (length, rank) pair maps to a symbol with one
    lookup.  Mirrors canonical_codes (ops/canonical.py) on the decode side.
    """
    A = lengths.shape[0]
    sym = jnp.arange(A, dtype=jnp.int32)
    one_hot = (lengths[:, None] == jnp.arange(max_len + 1)[None, :]).astype(jnp.int32)
    count = one_hot.sum(axis=0).at[0].set(0)  # [L+1]

    first_code = jnp.zeros(max_len + 1, dtype=jnp.int32)
    code = 0
    for l in range(1, max_len + 1):
        code = (code + count[l - 1]) << 1
        first_code = first_code.at[l].set(code)
    offset = jnp.cumsum(count) - count  # rank of first length-l symbol

    key = jnp.where(lengths > 0, lengths * 512 + sym, _BIGPOS + sym)
    sym_sorted = jax.lax.sort([key, sym], num_keys=1, is_stable=False)[1]
    return first_code, count, offset, sym_sorted


def _decode_at_all_bits(bitw, W: int, tables, max_len: int, A: int):
    """Per-bit speculative decode: (sym, codelen) if a code started at b.

    bitw: int32[W + max_len] 0/1 bits.  Unresolvable offsets get sym = -1,
    codelen = max_len (any value; such offsets are never on the token orbit
    of a valid stream, or invalidate the block via the `ok` reduction).
    """
    first_code, count, offset, sym_sorted = tables
    c = jnp.zeros(W, jnp.int32)
    found = jnp.zeros(W, jnp.bool_)
    codelen = jnp.full(W, max_len, jnp.int32)
    sym_pos = jnp.zeros(W, jnp.int32)
    for l in range(1, max_len + 1):
        c = (c << 1) | jax.lax.dynamic_slice(bitw, [l - 1], [W])
        ok = (~found) & (c >= first_code[l]) & (c < first_code[l] + count[l])
        sym_pos = jnp.where(ok, offset[l] + c - first_code[l], sym_pos)
        codelen = jnp.where(ok, l, codelen)
        found = found | ok
    sym = table_lookup(sym_sorted, sym_pos, A)
    return jnp.where(found, sym, -1), codelen


# ------------------------------- arithmetic length/dist base + extra bits --


def _len_attrs(lc):
    """(extra_bits, base) for length code index 0..28 — arithmetic, no tables
    (RFC 1951 §3.2.5; same values as constants.LENGTH_BASE/EXTRA, asserted in
    tests)."""
    e = jnp.maximum(0, (lc - 4) >> 2)
    base = jnp.where(lc < 4, lc + 3, (((lc & 3) + 4) << e) + 3)
    e = jnp.where(lc == 28, 0, e)
    base = jnp.where(lc == 28, C.MAX_MATCH, base)
    return e, base


def _dist_attrs(dc):
    """(extra_bits, base) for distance code 0..29."""
    e = jnp.maximum(0, (dc >> 1) - 1)
    base = jnp.where(dc < 2, dc + 1, (((dc & 1) + 2) << e) + 1)
    return e, base


# ---------------------------------------------------------------------------
# Dynamic header parse (RFC 1951 §3.2.7) — scalar while_loop on device
# ---------------------------------------------------------------------------


def _parse_dynamic_header(bits, pos):
    """Decode HLIT/HDIST/HCLEN + clen codes + RLE'd lengths at bit ``pos``.

    Returns (litlen_lengths[288], dist_lengths[30], pos_after).  Scalar
    device loop (~hlit+hdist iterations); bounded by the spec's 316 symbols.
    """

    def rd(p, k):  # k bits LSB-first at p (k static)
        acc = jnp.int32(0)
        for j in range(k):
            acc = acc | (jax.lax.dynamic_slice(bits, [p + j], [1])[0] << j)
        return acc

    hlit = rd(pos, 5) + 257
    hdist = rd(pos + 5, 5) + 1
    hclen = rd(pos + 10, 4) + 4
    pos = pos + 14

    # 3-bit clen code lengths in the spec's order.
    order = _const(C.CLEN_ORDER)
    cl_lens = jnp.zeros(C.NUM_CLEN_SYMBOLS, jnp.int32)

    def set_cl(i, carry):
        cl_lens, p = carry
        v = rd(p, 3)
        v = jnp.where(i < hclen, v, 0)
        cl_lens = jnp.where(jnp.arange(19) == jnp.take(order, i), v, cl_lens)
        return cl_lens, jnp.where(i < hclen, p + 3, p)

    cl_lens, pos = jax.lax.fori_loop(0, 19, set_cl, (cl_lens, pos))
    fc, cnt, off, ssym = _decode_tables(cl_lens, C.MAX_CLEN_CODE_LENGTH)

    CLL = 320  # hlit + hdist <= 288 + 30, padded
    lens = jnp.zeros(CLL, jnp.int32)
    total = hlit + hdist

    def cond(st):
        i, p, prev, lens = st
        return i < total

    def body(st):
        i, p, prev, lens = st
        # decode one clen symbol (scalar MSB accumulation)
        c = jnp.int32(0)
        l_found = jnp.int32(0)
        rank = jnp.int32(0)
        for l in range(1, C.MAX_CLEN_CODE_LENGTH + 1):
            c = (c << 1) | jax.lax.dynamic_slice(bits, [p + l - 1], [1])[0]
            hit = (l_found == 0) & (c >= fc[l]) & (c < fc[l] + cnt[l])
            rank = jnp.where(hit, off[l] + c - fc[l], rank)
            l_found = jnp.where(hit, l, l_found)
        s = jnp.take(ssym, rank)
        p = p + l_found
        # literal length 0..15 / 16 repeat-prev / 17,18 zero runs
        rep_bits = jnp.where(s == 16, 2, jnp.where(s == 17, 3, jnp.where(s == 18, 7, 0)))
        rep_base = jnp.where(s == 16, 3, jnp.where(s == 17, 3, jnp.where(s == 18, 11, 1)))
        ext = jnp.int32(0)
        for j in range(7):
            ext = ext | jnp.where(
                j < rep_bits, jax.lax.dynamic_slice(bits, [p + j], [1])[0] << j, 0
            )
        p = p + rep_bits
        n_rep = rep_base + ext
        val = jnp.where(s <= 15, s, jnp.where(s == 16, prev, 0))
        idx = jnp.arange(CLL)
        lens = jnp.where((idx >= i) & (idx < i + n_rep), val, lens)
        prev = jnp.where(s <= 15, s, jnp.where(s == 16, prev, 0))
        return i + n_rep, p, prev, lens

    _, pos, _, lens = jax.lax.while_loop(cond, body, (jnp.int32(0), pos, jnp.int32(0), lens))
    l_full = jnp.where(jnp.arange(C.NUM_LITLEN_SYMBOLS) < hlit,
                       lens[: C.NUM_LITLEN_SYMBOLS], 0)
    j = jnp.clip(jnp.arange(C.NUM_DIST_SYMBOLS) + hlit, 0, CLL - 1)
    d_full = jnp.where(jnp.arange(C.NUM_DIST_SYMBOLS) < hdist, jnp.take(lens, j), 0)
    return l_full, d_full, pos


# ---------------------------------------------------------------------------
# One block
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _block_decoder(NB: int, OUT: int, W: int):
    """Jitted per-block decoder for a stream of <= NB bytes and <= OUT output
    bytes; W = static block bit-window (must cover any single block)."""
    NBITS = NB * 8

    def decode_block(data, bitpos, out_pos, lit, src, known):
        bits = ((data[:, None] >> jnp.arange(8, dtype=jnp.uint8)[None, :]) & 1).astype(
            jnp.int32
        ).reshape(-1)
        bitsp = jnp.concatenate([bits, jnp.zeros(W + 64, jnp.int32)])

        bfinal = jax.lax.dynamic_slice(bitsp, [bitpos], [1])[0]
        btype = (
            jax.lax.dynamic_slice(bitsp, [bitpos + 1], [1])[0]
            | (jax.lax.dynamic_slice(bitsp, [bitpos + 2], [1])[0] << 1)
        )
        hpos = bitpos + 3

        def stored(_):
            p = (hpos + 7) & ~7  # pad to byte
            byte0 = p >> 3
            ln = jnp.int32(0)
            for j in range(16):
                ln = ln | (jax.lax.dynamic_slice(bitsp, [p + j], [1])[0] << j)
            # copy ln bytes data[byte0+4 + k] -> out[out_pos + k]
            k = jnp.arange(OUT, dtype=jnp.int32)
            sidx = jnp.clip(byte0 + 4 + k - out_pos, 0, NB - 1)
            v = jnp.take(data, sidx).astype(jnp.int32)
            inblk = (k >= out_pos) & (k < out_pos + ln)
            lit2 = jnp.where(inblk, v, lit)
            src2 = jnp.where(inblk, k, src)
            known2 = known | inblk
            return (lit2, src2, known2, (byte0 + 4) * 8 + ln * 8,
                    out_pos + ln, jnp.int32(1))

        def huffman(_):
            def dyn(_):
                return _parse_dynamic_header(bitsp, hpos)

            def fix(_):
                return (_const(C.FIXED_LITLEN_LENGTHS) + jnp.zeros(288, jnp.int32),
                        _const(C.FIXED_DIST_LENGTHS) + jnp.zeros(30, jnp.int32),
                        hpos)

            l_len, d_len, tstart = jax.lax.cond(btype == 2, dyn, fix, None)
            l_tab = _decode_tables(l_len, C.MAX_CODE_LENGTH)
            d_tab = _decode_tables(d_len, C.MAX_CODE_LENGTH)

            bitw = jax.lax.dynamic_slice(bitsp, [tstart], [W + 64])
            lsym, l1 = _decode_at_all_bits(bitw, W, l_tab, C.MAX_CODE_LENGTH, 288)
            dsym_b, l2_b = _decode_at_all_bits(bitw, W, d_tab, C.MAX_CODE_LENGTH, 30)

            # 16-bit LSB windows at every offset (extra-bit reads).
            win = jnp.zeros(W, jnp.int32)
            for j in range(16):
                win = win | (jax.lax.dynamic_slice(bitw, [j], [W]) << j)

            b = jnp.arange(W, dtype=jnp.int32)
            is_lit = (lsym >= 0) & (lsym <= 255)
            is_eob = lsym == C.END_OF_BLOCK
            is_len = lsym >= 257

            lc = jnp.clip(lsym - 257, 0, 28)
            e1, base1 = _len_attrs(lc)
            evw = jnp.take(win, jnp.clip(b + l1, 0, W - 1))
            ev = evw & ((1 << e1) - 1)
            len_val = base1 + ev

            b2 = jnp.clip(b + l1 + e1, 0, W - 1)
            dsym = jnp.take(dsym_b, b2)
            l2 = jnp.take(l2_b, b2)
            dc = jnp.clip(dsym, 0, 29)
            e2, base2 = _dist_attrs(dc)
            dvw = jnp.take(win, jnp.clip(b2 + l2, 0, W - 1))
            dist_val = base2 + (dvw & ((1 << e2) - 1))

            bad = (lsym < 0) | (is_len & (dsym < 0))
            step = jnp.where(
                is_lit, l1,
                jnp.where(is_len, l1 + e1 + l2 + e2, jnp.int32(W)),
            )
            step = jnp.where(bad | is_eob, jnp.int32(W), step)
            step = jnp.maximum(step, 1)

            # Token orbit from offset 0 of the window (log-depth doubling).
            nxt = jnp.minimum(jnp.arange(W + 1, dtype=jnp.int32)[:W] + step, W)
            tok = reachable(jnp.concatenate([nxt, jnp.full(1, W, jnp.int32)]), 0)[:W]

            # Output offsets per token.
            cnt = jnp.where(tok & is_lit, 1, jnp.where(tok & is_len, len_val, 0))
            ooff = out_pos + jnp.cumsum(cnt) - cnt

            # Literals: one scatter (unique ascending destinations).
            # NOTE: no unique/sorted scatter hints — the OUT sentinel for
            # masked rows repeats and interleaves, so the hints would lie.
            lit_idx = jnp.where(tok & is_lit, ooff, OUT)
            lit2 = jnp.asarray(lit, jnp.int32).at[lit_idx].set(
                jnp.where(is_lit, lsym, 0), mode="drop"
            )
            known2 = known.at[lit_idx].set(True, mode="drop")

            # Matches: scatter (start, dist) then forward-fill over the span.
            m_idx = jnp.where(tok & is_len, ooff, OUT)
            mstart = jnp.full(OUT, -1, jnp.int32).at[m_idx].set(
                jnp.where(is_len, ooff, -1), mode="drop")
            mdist = jnp.zeros(OUT, jnp.int32).at[m_idx].set(
                jnp.where(is_len, dist_val, 0), mode="drop")
            # also mark literal bytes as span breakers so fills stop there
            breaker = jnp.full(OUT, -1, jnp.int32).at[lit_idx].set(
                jnp.where(is_lit, ooff, -1), mode="drop")
            start_any = jnp.maximum(mstart, breaker)
            last_start = jax.lax.cummax(start_any, axis=0)
            d_at = jnp.take(mdist, jnp.clip(last_start, 0, OUT - 1))
            is_match_start = jnp.take(mstart, jnp.clip(last_start, 0, OUT - 1)) >= 0

            eob_pos = jnp.min(jnp.where(tok & is_eob, jnp.arange(W), W))
            eob_len = jnp.take(l1, jnp.clip(eob_pos, 0, W - 1))
            n_add = jnp.sum(cnt)

            k = jnp.arange(OUT, dtype=jnp.int32)
            in_new = (k >= out_pos) & (k < out_pos + n_add)
            fill = in_new & ~known2 & is_match_start & (last_start >= 0)
            src2 = jnp.where(fill, k - d_at, src)

            ok = (eob_pos < W) & jnp.logical_not(jnp.any(tok & (step >= W) & ~is_eob))
            return (lit2, src2, known2, tstart + eob_pos + eob_len,
                    out_pos + n_add, ok.astype(jnp.int32))

        lit2, src2, known2, nbitpos, nout, ok = jax.lax.cond(
            btype == 0, stored, huffman, None
        )
        meta = jnp.stack([nbitpos, nout, bfinal, ok, btype]).astype(jnp.int32)
        return lit2, src2, known2, meta

    return jax.jit(decode_block)


@functools.lru_cache(maxsize=None)
def _resolver(OUT: int):
    def resolve(lit, src, known, n):
        val = jnp.where(known, lit, 0)
        steps = max(1, (OUT - 1).bit_length())
        for _ in range(steps):
            v2 = jnp.take(val, src)
            k2 = jnp.take(known, src)
            val = jnp.where(known, val, v2)
            known = known | k2
            src = jnp.take(src, src)
        return val.astype(jnp.uint8), jnp.all(
            jnp.where(jnp.arange(OUT) < n, known, True)
        )

    return jax.jit(resolve)


def inflate_device(stream: bytes, out_cap: int, *, block_window: int = 0):
    """Decode a raw DEFLATE stream with all decode math on device.

    Args:
      stream: the compressed bytes (raw deflate, no zlib/gzip framing).
      out_cap: static output capacity (>= decoded size).
      block_window: static per-block bit window; defaults to a cover for
        out_cap-bounded blocks (any single block's payload must fit out_cap).

    Returns the decoded bytes.  Raises ValueError on a malformed stream or a
    block exceeding the window (the validator contract — not a lenient
    decoder).
    """
    NB = max(1024, int(np.ceil((len(stream) + 8) / 1024)) * 1024)
    OUT = out_cap
    W = block_window or min(9 * OUT + 4096, NB * 8 + 64)
    W = (W + 15) & ~15
    dec = _block_decoder(NB, OUT, W)
    data = jnp.asarray(
        np.frombuffer(stream.ljust(NB, b"\0"), np.uint8)
    )
    lit = jnp.zeros(OUT, jnp.int32)
    src = jnp.arange(OUT, dtype=jnp.int32)
    known = jnp.zeros(OUT, jnp.bool_)
    bitpos = jnp.int32(0)
    out_pos = jnp.int32(0)
    for _ in range(4096):  # block-count guard
        lit, src, known, meta = dec(data, bitpos, out_pos, lit, src, known)
        nbitpos, nout, bfinal, ok, btype = (int(x) for x in np.asarray(meta))
        # Compare against the TRUE stream length, not the padded buffer: the
        # zero padding would otherwise be decodable (fixed code 0000000 is
        # EOB), silently accepting a truncated stream.
        if not ok or nout > OUT or nbitpos > len(stream) * 8:
            raise ValueError(
                f"inflate_device: bad block (btype={btype}, ok={ok}, "
                f"out={nout}/{OUT}, bitpos={nbitpos})"
            )
        bitpos, out_pos = jnp.int32(nbitpos), jnp.int32(nout)
        if bfinal:
            break
    else:
        raise ValueError("inflate_device: no final block in 4096 blocks")
    out, resolved = _resolver(OUT)(lit, src, known, int(out_pos))
    if not bool(resolved):
        raise ValueError("inflate_device: unresolved back-references")
    return np.asarray(out)[: int(out_pos)].tobytes()
