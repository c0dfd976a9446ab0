"""Quantify cross-seam match clipping at 64 KiB chunk boundaries.

The reference's window slides continuously (lz77.rs:744-756); here a match
is clipped at its chunk's emit end (limit = n_total - i, matching.py:131),
so a match starting in the last ~258 bytes of a chunk cannot extend into
the next chunk — bounded at ~1 truncated match per seam (the next chunk's
full 32 KiB halo re-covers the truncated tail).  This probe measures that
loss.

Method (stream-level, full production encoder, no mirrored internals):

1. Encode the corpus with the real chunked pipeline (seams at k * 64 Ki).
2. Encode ``data[32Ki:]`` — the same bytes with every original seam now
   interior (its own seams sit 32 Ki away).  History depth at any position
   >= 32 Ki in is identical (32 KiB halo), so around an original seam
   position the ONLY difference is the seam itself.
3. Inflate both streams into token lists with absolute positions
   (``tokens`` below) and compare, per original seam
   a, the token bits inside the window [a-300, a+300), costed with the
   FIXED Huffman table for both parses (per-block dynamic tables would
   conflate table drift with parse differences).  Bits are normalized by
   the bytes the counted tokens cover, so differing token overhang at the
   window edges cancels.

Reported per corpus: per-seam mean/max delta bits, total delta as a
fraction of compressed output, and the count of seam-clipped matches
(matches in the normal parse ending exactly at a seam, continued by a
same-distance match in the shifted parse).
"""

from __future__ import annotations

import glob
import io
import os
import sys
import tarfile
import zlib

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
os.environ["JAX_PLATFORMS"] = "cpu"
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from deflate_rs_tpu import constants as C  # noqa: E402
from deflate_rs_tpu.models.inflate import inflate  # noqa: E402
from deflate_rs_tpu.parallel.corpus import compress_corpus  # noqa: E402

E = 64 * 1024
SHIFT = 32 * 1024
WIN = 300


def tokens(data: bytes):
    """Token list of a raw DEFLATE stream: ('lit', byte) / ('m', len, dist)."""
    toks = []
    inflate(data, tokens=toks)
    return toks


def fixed_bits(tok) -> int:
    """Exact fixed-Huffman bit cost of one token (the shared proxy)."""
    if tok[0] == "lit":
        return int(C.FIXED_LITLEN_LENGTHS[tok[1]])
    _, ln, d = tok
    lc = int(C.LENGTH_TO_CODE[ln])
    dc = int(C.DIST_TO_CODE[d])
    return (
        int(C.FIXED_LITLEN_LENGTHS[257 + lc])
        + int(C.LENGTH_EXTRA_BITS[lc])
        + 5
        + int(C.DIST_EXTRA_BITS[dc])
    )


def positioned(toks):
    """[(start, end, bits, tok)] with absolute byte positions."""
    out = []
    pos = 0
    for t in toks:
        ln = 1 if t[0] == "lit" else t[1]
        out.append((pos, pos + ln, fixed_bits(t), t))
        pos += ln
    return out


def window_cost(ptoks, lo, hi):
    """(bits, covered_bytes) of tokens starting in [lo, hi)."""
    bits = cov = 0
    for s, e, b, _ in ptoks:
        if s >= hi:
            break
        if s >= lo:
            bits += b
            cov += e - s
    return bits, cov


def analyze(name: str, data: bytes):
    n = len(data)
    res_a = compress_corpus(data, chunk_size=E)
    res_b = compress_corpus(data[SHIFT:], chunk_size=E)
    assert zlib.decompress(res_a.deflate, wbits=-15) == data
    assert zlib.decompress(res_b.deflate, wbits=-15) == data[SHIFT:]
    pa = positioned(tokens(res_a.deflate))
    pb = [(s + SHIFT, e + SHIFT, b, t) for (s, e, b, t) in positioned(tokens(res_b.deflate))]

    seams = [k * E for k in range(1, n // E) if k * E + WIN < n]
    deltas, clipped = [], 0
    for a in seams:
        ba, ca = window_cost(pa, a - WIN, a + WIN)
        bb, cb = window_cost(pb, a - WIN, a + WIN)
        if min(ca, cb) == 0:
            continue
        # normalize to bits per 2*WIN bytes via each parse's own coverage
        deltas.append(ba / ca * 2 * WIN - bb / cb * 2 * WIN)
        # clipped match: normal parse has a match ending exactly at a whose
        # shifted counterpart (same start window, same distance) crosses a.
        for s, e, _, t in pa:
            if t[0] == "m" and e == a and a - s < 258:
                for s2, e2, _, t2 in pb:
                    if t2[0] == "m" and s2 <= s < e2 and e2 > a and t2[2] == t[2]:
                        clipped += 1
                        break
    out_bits = len(res_a.deflate) * 8
    total_delta = sum(deltas)
    print(
        f"{name:10s} seams={len(deltas):2d} clipped={clipped:2d} "
        f"mean_dbits={np.mean(deltas):+7.1f} max_dbits={max(deltas, default=0):+7.1f} "
        f"total_dbits={total_delta:+8.1f} = {total_delta / out_bits * 100:+.4f}% of output"
    )
    return total_delta / out_bits


def corpora(cap: int):
    out = {}
    for nm, path in (
        ("libc_elf", "/usr/lib/x86_64-linux-gnu/libc.so.6"),
        ("bash_elf", "/bin/bash"),
        ("sqlite_db", "/usr/share/proj/proj.db"),
    ):
        if os.path.exists(path):
            out[nm] = open(path, "rb").read()[:cap]
    docs = []
    for p in sorted(glob.glob("/usr/share/doc/*/copyright"))[:2000]:
        try:
            docs.append(open(p, "rb").read())
        except OSError:
            continue
        if sum(map(len, docs)) > cap:
            break
    out["doc_text"] = b"".join(docs)[:cap]
    js = []
    for p in sorted(glob.glob("/usr/share/gdal/*.json"))[:200]:
        js.append(open(p, "rb").read())
        if sum(map(len, js)) > cap:
            break
    out["json_cfg"] = b"".join(js)[:cap]
    py = []
    npdir = os.path.dirname(np.__file__)
    for p in sorted(glob.glob(os.path.join(npdir, "**", "*.py"), recursive=True)):
        py.append(open(p, "rb").read())
        if sum(map(len, py)) > cap:
            break
    out["py_source"] = b"".join(py)[:cap]
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    pg = open(os.path.join(here, "tests", "data", "pg11.txt"), "rb").read()
    out["pg11"] = (pg * (cap // len(pg) + 1))[:cap]
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as t:
        total = 0
        for p in sorted(glob.glob(os.path.join(npdir, "**", "*"), recursive=True)):
            if os.path.isfile(p):
                t.add(p, arcname=os.path.relpath(p, npdir))
                total += os.path.getsize(p)
            if total > cap:
                break
    out["tar_tree"] = buf.getvalue()[:cap]
    return out


if __name__ == "__main__":
    cap = int(os.environ.get("SEAM_CAP_KB", "512")) << 10
    worst = 0.0
    for nm, data in sorted(corpora(cap).items()):
        worst = max(worst, abs(analyze(nm, data)))
    print(f"worst |delta| = {worst * 100:.4f}% of output (threshold 0.05%)")
