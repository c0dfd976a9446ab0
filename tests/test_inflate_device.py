"""Device-side inflate (ops/inflate_device.py) — the on-device decode validator.

Exercised here on the CPU backend (same jitted code, per conftest); the
compiled run on a GPU is chip_smoke.py's decode phase.  Two
directions, matching the reference's oracle discipline (test_utils.rs:23-72,
inverted): decode OUR encoder's streams, and decode stdlib-zlib streams —
an encoder-independent check of the decoder itself.
"""

import os
import zlib

import numpy as np
import pytest

import deflate_rs_tpu as dt
from deflate_rs_tpu import Compression, CompressionOptions
from deflate_rs_tpu.ops.inflate_device import inflate_device, _len_attrs, _dist_attrs

DATA_DIR = os.path.join(os.path.dirname(__file__), "data")


def _cap(n):
    return max(4096, (n + 4095) & ~4095)


def _roundtrip_ours(data, options):
    stream = dt.deflate_bytes_conf(data, options)
    out = inflate_device(stream, _cap(len(data)))
    assert out == data


def test_len_dist_attr_formulas_match_tables():
    import deflate_rs_tpu.constants as C

    e, b = _len_attrs(np.arange(29))
    np.testing.assert_array_equal(np.asarray(e), C.LENGTH_EXTRA_BITS)
    np.testing.assert_array_equal(np.asarray(b), C.LENGTH_BASE)
    e, b = _dist_attrs(np.arange(30))
    np.testing.assert_array_equal(np.asarray(e), C.DIST_EXTRA_BITS)
    np.testing.assert_array_equal(np.asarray(b), C.DIST_BASE)


@pytest.mark.parametrize("preset", ["default", "fast", "rle", "huffman_only"])
def test_decode_our_text(preset):
    with open(os.path.join(DATA_DIR, "pg11.txt"), "rb") as f:
        data = f.read()[:16384]
    _roundtrip_ours(data, getattr(CompressionOptions, preset)())


def test_decode_our_fixed_block():
    _roundtrip_ours(b"Deflate late", CompressionOptions.default())


def test_decode_our_stored_random():
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, 50000, dtype=np.uint8).tobytes()
    _roundtrip_ours(data, CompressionOptions.default())


def test_decode_our_rle_runs():
    data = b"\x00" * 9000 + b"ab" * 700 + b"\xff" * 3000
    _roundtrip_ours(data, CompressionOptions.rle())


def test_decode_our_multichunk_with_sync_markers():
    # > 64 KiB forces two chunks: a sync marker (empty stored block) sits
    # between them and matches may cross the seam via the history halo.
    with open(os.path.join(DATA_DIR, "pg11.txt"), "rb") as f:
        data = f.read()[:80000]
    _roundtrip_ours(data, Compression.Default)


def test_decode_our_structured_binary():
    with open(os.path.join(DATA_DIR, "issue_18_201911.bin"), "rb") as f:
        data = f.read()
    _roundtrip_ours(data, CompressionOptions.default())


@pytest.mark.parametrize("level", [1, 6, 9])
def test_decode_zlib_streams(level):
    # Encoder-independent direction: streams produced by stdlib zlib.
    with open(os.path.join(DATA_DIR, "pg11.txt"), "rb") as f:
        data = f.read()[:20000]
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    stream = co.compress(data) + co.flush()
    assert inflate_device(stream, _cap(len(data))) == data


def test_decode_zlib_mixed_content():
    rng = np.random.default_rng(9)
    data = (b"A" * 5000 + rng.integers(0, 256, 8000, dtype=np.uint8).tobytes()
            + b"the quick brown fox " * 400)
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    stream = co.compress(data) + co.flush()
    assert inflate_device(stream, _cap(len(data))) == data


def test_decode_empty_and_tiny():
    for data in (b"", b"x", b"ab" * 3):
        stream = dt.deflate_bytes(data)
        assert inflate_device(stream, 4096) == data


def test_malformed_stream_raises():
    with pytest.raises(ValueError):
        inflate_device(b"\xff" * 64, 4096)
