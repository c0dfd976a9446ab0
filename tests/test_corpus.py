"""Batched corpus API: identical output to the chunk-by-chunk one-shot."""

import os
import zlib

import numpy as np

import deflate_rs_tpu as dt
from deflate_rs_tpu.parallel.corpus import (
    compress_corpus_gzip,
    compress_corpus_zlib,
)

DATA_DIR = os.path.join(os.path.dirname(__file__), "data")


def test_corpus_matches_oneshot():
    with open(os.path.join(DATA_DIR, "pg11.txt"), "rb") as f:
        data = f.read()
    # Mix in binary so multiple block types appear across the batch.
    rng = np.random.default_rng(0)
    data = data + rng.integers(0, 256, 80_000, dtype=np.uint8).tobytes() + data[:50_000]

    z = compress_corpus_zlib(data, batch_size=3)
    assert zlib.decompress(z) == data
    # Pin the two engines' byte identity explicitly: deflate_bytes_zlib
    # auto-routes large inputs through the corpus engine, so compare against
    # the chunk-by-chunk engine directly.
    from deflate_rs_tpu.models.deflate import compress_stream
    from deflate_rs_tpu.compression_options import CompressionOptions

    legacy = compress_stream(data, CompressionOptions.default(), pipelined=False)
    assert z[2:-4] == legacy.deflate
    assert z == dt.deflate_bytes_zlib(data)

    import gzip as _gz

    g = compress_corpus_gzip(data, batch_size=5)
    assert _gz.decompress(g) == data


def test_corpus_empty_and_small():
    assert zlib.decompress(compress_corpus_zlib(b"")) == b""
    assert zlib.decompress(compress_corpus_zlib(b"hi")) == b"hi"


def test_corpus_compaction_paths():
    """Exercise the device-side used-prefix compaction's edge shapes:
    stored-only batches (zero used words), a batch whose used words exceed
    the fixed head cap (forces the rest-piece fetch), and mixed batches."""
    from deflate_rs_tpu.parallel.corpus import compress_corpus

    rng = np.random.default_rng(7)
    rand = rng.integers(0, 256, 3 * 65536, dtype=np.uint8).tobytes()

    # All-stored batch: every chunk incompressible -> compact buffer empty.
    res = compress_corpus(rand, batch_size=3)
    assert zlib.decompress(res.deflate, wbits=-15) == rand
    assert res.crc32 == zlib.crc32(rand)

    # Barely-compressible Huffman chunks: used words > cap (= half the
    # worst-case buffer) so the fetch path concatenates the rest piece.
    # Uniform bytes over 64 symbols entropy-code to ~6 bits/byte — dynamic
    # blocks at ~0.75 ratio, well past the 50% cap but cheaper than stored.
    dense = rng.integers(0, 64, 4 * 65536, dtype=np.uint8).tobytes()
    res = compress_corpus(dense, batch_size=4)
    assert zlib.decompress(res.deflate, wbits=-15) == dense
    assert len(res.deflate) > 0.5 * len(dense)  # the cap-overflow regime

    # Mixed: stored + text + runs in one batch, odd tail.
    with open(os.path.join(DATA_DIR, "pg11.txt"), "rb") as f:
        text = f.read()
    mixed = rand[:65536] + text[:100_000] + b"\x00" * 70_000 + rand[: 12_345]
    res = compress_corpus(mixed, batch_size=4)
    assert zlib.decompress(res.deflate, wbits=-15) == mixed
    assert res.deflate == dt.deflate_bytes(mixed)


def test_corpus_chunk_grain():
    """chunk_size is checked against the options' real granularity: a size
    the long-range segments cannot divide is refused up front, and a
    non-power-of-two multiple of the grain encodes."""
    import pytest

    from deflate_rs_tpu.compression_options import CompressionOptions as CO
    from deflate_rs_tpu.parallel.corpus import chunk_grain, compress_corpus

    assert [chunk_grain(CO.default()), chunk_grain(CO.high()), chunk_grain(CO.fast())] == [
        256, 128, 16,
    ]
    with open(os.path.join(DATA_DIR, "pg11.txt"), "rb") as f:
        data = f.read()[:20_000]
    with pytest.raises(ValueError, match="multiple of 256"):
        compress_corpus(data, CO.default(), chunk_size=65536 + 16)
    res = compress_corpus(data, CO.default(), batch_size=2, chunk_size=4096 + 256)
    assert zlib.decompress(res.deflate, wbits=-15) == data


def test_corpus_large_chunks():
    """256 KiB device chunks: valid stream, ratio no worse than 64 KiB."""
    from deflate_rs_tpu.parallel.corpus import compress_corpus

    with open(os.path.join(DATA_DIR, "pg11.txt"), "rb") as f:
        text = f.read()
    data = (text * 4)[:600_000]

    big = compress_corpus(data, batch_size=2, chunk_size=262_144)
    assert zlib.decompress(big.deflate, wbits=-15) == data
    assert big.adler == zlib.adler32(data)

    small = compress_corpus(data, batch_size=2)
    # Fewer seams and the same window limit: larger chunks never cost ratio
    # beyond the removed per-chunk framing (allow a few bytes of noise).
    assert len(big.deflate) <= len(small.deflate) + 64
