"""Roundtrip and golden-vector tests for the one-shot API.

Mirrors the reference's oracle strategy (test_utils.rs:23-72): compress with
this library, decompress with an independent decoder (stdlib zlib, standing in
for miniz_oxide), assert byte equality — plus our own spec inflate as a second
oracle, and the reference's pinned golden vectors.
"""

import os
import zlib

import numpy as np
import pytest

import deflate_rs_tpu as dt
from deflate_rs_tpu import Compression, CompressionOptions, SpecialOptions
from deflate_rs_tpu.models.inflate import inflate, inflate_gzip, inflate_zlib

DATA_DIR = os.path.join(os.path.dirname(__file__), "data")


def load(name):
    with open(os.path.join(DATA_DIR, name), "rb") as f:
        return f.read()


def rt(data, options=None):
    out = dt.deflate_bytes_conf(data, options or CompressionOptions.default())
    assert zlib.decompress(out, wbits=-15) == data
    return out


# ---------------------------------------------------------------- golden


def test_fixed_example_golden():
    """Mark Adler's worked fixed-Huffman example (compress.rs:334-345)."""
    out = dt.deflate_bytes(b"Deflate late")
    assert out == bytes.fromhex("73494dcb492c4955001100")


def test_six_byte_rle_golden():
    """[10,10,10,10,10,55] -> exactly 5 bytes as a fixed block (lib.rs:383-391)."""
    out = rt(bytes([10, 10, 10, 10, 10, 55]))
    assert len(out) == 5


def test_short_bin_30_bytes():
    """34-byte short.bin compresses to exactly 30 bytes zlib (test.rs:59-66)."""
    data = load("short.bin")
    out = dt.deflate_bytes_zlib(data)
    assert zlib.decompress(out) == data
    assert len(out) <= 30  # reference: exactly 30


def test_empty_and_tiny():
    """Edge inputs: empty, 1..4 bytes at every level (lib.rs:463-485)."""
    for opts in [
        CompressionOptions.fast(),
        CompressionOptions.default(),
        CompressionOptions.high(),
        CompressionOptions.rle(),
        CompressionOptions.huffman_only(),
    ]:
        for data in [b"", b"!", b"ab", b"abc", b"aaaa", b"\x00" * 4]:
            rt(data, opts)
            z = dt.deflate_bytes_zlib_conf(data, opts)
            assert zlib.decompress(z) == data


# ---------------------------------------------------------------- corpora


@pytest.fixture(scope="module")
def pg11():
    return load("pg11.txt")


def test_pg11_all_levels(pg11):
    """pg11 compresses smaller than input and roundtrips at all levels
    (lib.rs:318-338)."""
    sizes = {}
    for name, opts in [
        ("fast", CompressionOptions.fast()),
        ("default", CompressionOptions.default()),
        ("high", CompressionOptions.high()),
        ("rle", CompressionOptions.rle()),
        ("huffman_only", CompressionOptions.huffman_only()),
    ]:
        out = rt(pg11, opts)
        sizes[name] = len(out)
        assert len(out) < len(pg11)
    assert sizes["high"] <= sizes["default"] <= sizes["fast"]
    assert sizes["default"] < sizes["huffman_only"]


def test_pg11_zlib_and_gzip_framing(pg11):
    z = dt.deflate_bytes_zlib(pg11)
    assert zlib.decompress(z) == pg11
    assert inflate_zlib(z) == pg11

    g = dt.deflate_bytes_gzip(pg11)
    import gzip as _gz

    assert _gz.decompress(g) == pg11
    assert inflate_gzip(g) == pg11


def test_gzip_header_fields(pg11):
    data = pg11[:5000]
    b = dt.GzBuilder().with_filename("alice.txt").with_comment("test").with_mtime(123456)
    g = dt.deflate_bytes_gzip_conf(data, b, Compression.Default)
    import gzip as _gz

    assert _gz.decompress(g) == data
    assert inflate_gzip(g) == data
    assert b"alice.txt\x00" in g[:40]


def test_issue_18_zeroes():
    """65,537 zero bytes (deflate-rs issue #17/#18 regression, test.rs:69-76)."""
    data = b"\x00" * 65537
    rt(data)
    rt(data, CompressionOptions.rle())


def test_issue_18_bin():
    data = load("issue_18_201911.bin")
    for opts in [CompressionOptions.default(), CompressionOptions.fast(), CompressionOptions.rle()]:
        rt(data, opts)


def test_issue_44_stream():
    """Recompress the decompressed issue-44 stream (test.rs:78-91)."""
    data = zlib.decompress(load("issue_44.zlib"))
    rt(data)


def test_incompressible_stored(pg11):
    """Random data must fall back to stored blocks with tiny overhead."""
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, 150_000, dtype=np.uint8).tobytes()
    out = rt(data)
    # 3 chunks: <= 5B/stored sub-block + 5B sync marker each, plus slack.
    assert len(out) <= len(data) + 64


def test_special_modes(pg11):
    data = pg11[:30000]
    fixed = rt(data, CompressionOptions(special=SpecialOptions.ForceFixed))
    stored = rt(data, CompressionOptions(special=SpecialOptions.ForceStored))
    assert len(stored) >= len(data)
    assert len(fixed) < len(stored)


def test_own_inflate_agrees_with_zlib(pg11):
    """Our inflate and stdlib zlib agree on every block type."""
    for data in [pg11[:70000], b"\x00" * 10000, os.urandom(40000)]:
        out = dt.deflate_bytes(data)
        assert inflate(out) == zlib.decompress(out, wbits=-15) == data


@pytest.mark.parametrize("level", [0, 1, 9])
def test_inflate_token_sink(pg11, level):
    """inflate's token list replays to the decoded bytes (stored, fixed and
    dynamic blocks from stdlib zlib)."""
    data = pg11[:6000] + b"\x00" * 300 + b"ab"
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    stream = co.compress(data) + co.flush()
    toks = []
    assert inflate(stream, tokens=toks) == data
    out = bytearray()
    for t in toks:
        if t[0] == "lit":
            out.append(t[1])
        else:
            _, length, dist = t
            for _ in range(length):
                out.append(out[-dist])
    assert bytes(out) == data
    assert any(t[0] == "m" for t in toks) == (level > 0)


def test_chunk_boundary_sizes():
    """Inputs straddling chunk/window boundaries (lz77.rs:993-1033 analogue)."""
    rng = np.random.default_rng(9)
    base = (b"the quick brown fox jumps over the lazy dog. " * 4000)
    for n in [4095, 4096, 4097, 32768, 65535, 65536, 65537, 98304, 131073]:
        data = base[:n]
        rt(data)


def test_stored_subblock_boundaries():
    """ForceStored at the 32 KiB sub-block boundaries (stored_block.rs edge)."""
    from deflate_rs_tpu import CompressionOptions, SpecialOptions

    opts = CompressionOptions(special=SpecialOptions.ForceStored)
    for n in (32767, 32768, 32769, 65535, 65536, 65537):
        data = bytes(range(256)) * (n // 256 + 1)
        data = data[:n]
        out = dt.deflate_bytes_conf(data, opts)
        assert zlib.decompress(out, wbits=-15) == data


def test_chunk_bit_accounting():
    """Non-final chunks must end byte-aligned on the sync marker and the
    reported data_bits must match the emitted structure (the cost model and
    the bit emitter must agree exactly or streams would corrupt)."""
    import numpy as np
    from deflate_rs_tpu.compression_options import CompressionOptions
    from deflate_rs_tpu.ops.chunk_encode import HALO, PAD, get_chunk_encoder

    enc = get_chunk_encoder(CompressionOptions.default(), 4096)
    rng = np.random.default_rng(0)
    for n in (0, 1, 100, 4095, 4096):
        buf = np.zeros(HALO + 4096 + PAD, np.uint8)
        buf[HALO : HALO + n] = rng.integers(0, 256, n, dtype=np.uint8)
        out = enc(buf, np.int32(0), np.int32(n), np.bool_(False))
        total, data_bits = int(out["total_bits"]), int(out["data_bits"])
        assert total % 8 == 0, "sync-flushed chunk must end byte-aligned"
        # data + 3-bit marker + pad + 4 marker bytes
        assert total == data_bits + 3 + (-(data_bits + 3)) % 8 + 32


def test_force_fixed_worst_case_high_literals():
    """ForceFixed + all-high literals is the 9-bit/byte worst case for the
    output buffer (round-1 overflow bug: the buffer was sized below
    9 bits/byte and the packing scatters dropped overflow silently)."""
    opts = CompressionOptions(
        max_hash_checks=0,  # huffman_only: every byte a literal
        lazy_if_less_than=0,
        matching_type=dt.MatchingType.Greedy,
        special=SpecialOptions.ForceFixed,
    )
    rng = np.random.default_rng(7)
    # Bytes in 144..255 take 9-bit fixed codes; 65537 spans two chunks.
    data = rng.integers(144, 256, 65_537, dtype=np.uint8).tobytes()
    out = dt.deflate_bytes_conf(data, opts)
    assert zlib.decompress(out, wbits=-15) == data
    # All literals at 9 bits plus block overhead.
    assert len(out) > len(data) * 9 // 8


def test_force_fixed_worst_case_with_matching():
    """Same adversarial bytes through the normal matcher (matches allowed)."""
    opts = CompressionOptions(special=SpecialOptions.ForceFixed)
    rng = np.random.default_rng(8)
    data = rng.integers(144, 256, 70_000, dtype=np.uint8).tobytes()
    out = dt.deflate_bytes_conf(data, opts)
    assert zlib.decompress(out, wbits=-15) == data
