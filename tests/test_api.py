"""API-surface parity tests: enum levels, option plumbing, inflate robustness."""

import io
import zlib

import pytest

import deflate_rs_tpu as dt
from deflate_rs_tpu import Compression, CompressionOptions, MatchingType, SpecialOptions
from deflate_rs_tpu.models.inflate import inflate, inflate_zlib
from deflate_rs_tpu.write import ZlibEncoder

DATA = b"the quick brown fox jumps over the lazy dog. " * 100


def test_compression_enum_everywhere():
    for level in (Compression.Fast, Compression.Default, Compression.Best):
        out = dt.deflate_bytes_conf(DATA, level)
        assert zlib.decompress(out, wbits=-15) == DATA
        sink = io.BytesIO()
        enc = ZlibEncoder(sink, options=level)
        enc.write(DATA)
        enc.finish()
        assert zlib.decompress(sink.getvalue()) == DATA


def test_from_compression_mapping():
    assert CompressionOptions.from_compression(Compression.Fast) == CompressionOptions.fast()
    assert CompressionOptions.from_compression(Compression.Default) == CompressionOptions.default()
    assert CompressionOptions.from_compression(Compression.Best) == CompressionOptions.high()


def test_option_values_mirror_reference():
    """Preset knob values match compression_options.rs."""
    d = CompressionOptions.default()
    assert (d.max_hash_checks, d.lazy_if_less_than, d.matching_type) == (128, 32, MatchingType.Lazy)
    h = CompressionOptions.high()
    assert (h.max_hash_checks, h.lazy_if_less_than) == (1768, 128)
    f = CompressionOptions.fast()
    assert (f.max_hash_checks, f.lazy_if_less_than, f.matching_type) == (1, 0, MatchingType.Greedy)
    r = CompressionOptions.rle()
    assert r.matcher_mode == "rle"
    assert CompressionOptions.huffman_only().matcher_mode == "none"
    assert d.special == SpecialOptions.Normal


def test_kernel_gates_resolve_into_options(monkeypatch):
    """No environment variable changes the options or their trace-cache
    identity: every preset resolves the same with the old kernel gates and
    the debug switches set, and the encoder never reads the environment."""
    import inspect

    from deflate_rs_tpu import compression_options
    from deflate_rs_tpu.ops import chunk_encode, package_merge

    presets = ("default", "fast", "high", "turbo", "rle", "huffman_only")
    base = {p: getattr(CompressionOptions, p)() for p in presets}
    for name, value in (
        ("DEFLATE_TPU_LR_KERNEL", "0"), ("DEFLATE_TPU_HIST_KERNEL", "1"),
        ("DEFLATE_TPU_FIELD_KERNEL", "0"), ("DEFLATE_TPU_PM_KERNEL", "0"),
        ("DEFLATE_TPU_DEBUG", "1"), ("DEFLATE_TPU_FETCH_SLICE", "0"),
    ):
        monkeypatch.setenv(name, value)
    for p in presets:
        opts = getattr(CompressionOptions, p)()
        assert opts == base[p]
        assert opts.cache_key() == base[p].cache_key()
        assert hash(opts) == hash(base[p])  # lru_cache (trace cache) identity
    for mod in (compression_options, package_merge):
        assert "environ" not in inspect.getsource(mod)
    assert "environ" not in inspect.getsource(chunk_encode.encode_chunk)


def test_numeric_block_split_validated():
    """Non-power-of-two block_split fails loudly in num_quarters itself,
    not via an encoder assert that vanishes under ``python -O``
    (ADVICE r4)."""
    for bad in ("3", "5", "0", "64", "-4"):
        with pytest.raises(ValueError):
            CompressionOptions(block_split=bad).num_quarters
    assert CompressionOptions(block_split="8").num_quarters == 8
    assert CompressionOptions(block_split="16").num_quarters == 16


def test_lr_selection_width_guard():
    """Out-of-range dominant-selection rows raise instead of silently
    mis-ranking (ADVICE r4: freq << 16 must stay in int32)."""
    import jax.numpy as jnp

    from deflate_rs_tpu.ops.longrange import _select_dominants

    with pytest.raises(ValueError, match="2\\^15"):
        _select_dominants(jnp.zeros(1 << 16, jnp.int32), 1, 4, 1)
    # In-range shapes pass (regression for the check being too eager).
    _select_dominants(jnp.zeros(1 << 16, jnp.int32), 4, 4, 1)


def test_inflate_rejects_corrupt_streams():
    good = dt.deflate_bytes_zlib(DATA)
    with pytest.raises(ValueError):
        inflate_zlib(good[:-1] + bytes([good[-1] ^ 0xFF]))  # bad adler
    with pytest.raises(ValueError):
        inflate_zlib(b"\x79" + good[1:])  # bad header check
    with pytest.raises(Exception):
        inflate(b"\x07\x00\x00")  # BTYPE=3 is invalid


def test_inflate_handles_all_reference_streams():
    """Our inflate decodes zlib-produced streams too (not just our own)."""
    for level in (1, 6, 9):
        z = zlib.compress(DATA, level)
        assert inflate_zlib(z) == DATA
    import os

    ref = open(os.path.join(os.path.dirname(__file__), "data", "issue_44.zlib"), "rb").read()
    assert inflate_zlib(ref) == zlib.decompress(ref)


def test_turbo_preset_roundtrips():
    """The turbo tier (max-throughput: huffman-only, one proxy-scored
    block per chunk) emits valid streams on every content class and sizes
    like an entropy coder."""
    import numpy as np

    t = CompressionOptions.turbo()
    assert t.matcher_mode == "none"
    assert t.num_quarters == 1 and not t.exact_split_scoring
    rng = np.random.default_rng(5)
    for payload in (
        DATA,
        b"",
        b"\x00" * 70000,
        rng.integers(0, 256, 70000, dtype=np.uint8).tobytes(),
    ):
        out = dt.deflate_bytes_conf(payload, t)
        assert zlib.decompress(out, wbits=-15) == payload
    # Entropy-only on text: smaller than stored, bigger than default.
    text = DATA * 20
    s_turbo = len(dt.deflate_bytes_conf(text, t))
    s_default = len(dt.deflate_bytes_conf(text, CompressionOptions.default()))
    assert s_default < s_turbo < len(text)


def test_probe_words_override_validated():
    """Out-of-range probe widths fail loudly at the options layer instead
    of surfacing as an unequal-shapes sort error inside the matcher
    (4 * probe_words is bounded by the chunk buffer's 72-byte PAD)."""
    for bad in (19, 32, -4):
        with pytest.raises(ValueError):
            CompressionOptions(probe_words_override=bad).probe_words
    # 0 means "per-preset default", not an override.
    assert CompressionOptions(probe_words_override=0).probe_words == 6
    assert CompressionOptions(probe_words_override=18).probe_words == 18
    assert CompressionOptions(probe_words_override=5).probe_words == 5


def test_inflate_public_surface():
    """inflate/inflate_zlib/inflate_gzip are first-class package exports
    (the reference ships no decoder; ours is a documented capability)."""
    payload = DATA * 7
    assert dt.inflate(dt.deflate_bytes(payload)) == payload
    assert dt.inflate_zlib(dt.deflate_bytes_zlib(payload)) == payload
    assert dt.inflate_gzip(dt.deflate_bytes_gzip(payload)) == payload
    # Cross-oracle: decode zlib-module output too.
    assert dt.inflate_zlib(zlib.compress(payload, 6)) == payload
    for name in ("inflate", "inflate_zlib", "inflate_gzip"):
        assert name in dt.__all__
