"""One-shot compression API and host-side stream assembly.

Counterpart of the reference's convenience layer (lib.rs:110-286:
``deflate_bytes[_conf]``, ``deflate_bytes_zlib[_conf]``,
``deflate_bytes_gzip[_conf]``).  The input is split into independent 64 KiB
chunks, each carrying the previous 32 KiB as match history (so parse quality
matches the reference's sliding window), encoded on device, and bit-spliced
on the host (models/assembly.py) into one marker-free stream — the same
framing overhead as the reference's one-shot path.  Checksums come from the
device partials combined with the streaming identities in ops.checksum.
"""

from __future__ import annotations

import numpy as np

from .. import constants as C
from ..compression_options import Compression, CompressionOptions
from ..ops.chunk_encode import HALO, PAD, get_chunk_encoder
from ..runtime import native
from .assembly import BitAssembler, splice_encoded_chunk
from .gzip_header import GzBuilder

# Chunk capacity tiers: small inputs use a small pipeline (lower latency and
# compile cost), everything else the full tier.  Chunk *boundaries* are always
# multiples of the full tier size, so output is independent of how the input
# arrives (chunk-determinism, lib.rs:408-433).
SMALL_EMIT = 4096
FULL_EMIT = 65536


def _encode_chunk_host(encoder, data: bytes, off: int, ln: int, is_last: bool, emit_size: int):
    """Build the padded device buffer for data[off:off+ln] and encode it."""
    buf = np.zeros(HALO + emit_size + PAD, dtype=np.uint8)
    hist_len = min(off, HALO)
    if hist_len:
        buf[HALO - hist_len : HALO] = np.frombuffer(data, np.uint8, hist_len, off - hist_len)
    if ln:
        buf[HALO : HALO + ln] = np.frombuffer(data, np.uint8, ln, off)
    out = encoder(buf, np.int32(hist_len), np.int32(ln), np.bool_(is_last))
    return out


class StreamResult:
    """Assembled deflate stream plus checksums of the raw input."""

    __slots__ = ("deflate", "adler", "crc32", "isize")

    def __init__(self, deflate: bytes, adler: int, crc32: int, isize: int):
        self.deflate = deflate
        self.adler = adler
        self.crc32 = crc32
        self.isize = isize


def compress_stream(
    data: bytes, options: CompressionOptions, *, packed: bool = True,
    pipelined: bool | None = None,
) -> StreamResult:
    """Compress ``data`` into a raw DEFLATE stream (with checksums).

    ``packed`` (the default) splices consecutive blocks at arbitrary bit
    phase — the reference's one-shot framing (sync markers only on explicit
    flush, compress.rs:257-262).  ``packed=False`` byte-aligns every chunk
    with a sync marker (the device-assembly framing used by the sharded
    pipeline, parallel/sharded.py).

    ``pipelined`` selects the batched corpus engine (parallel/corpus.py);
    the default auto-routes multi-chunk inputs there.  Both engines produce
    identical bytes (tested); ``pipelined=False`` pins the chunk-by-chunk
    engine (used by tests to assert that identity).
    """
    n = len(data)
    if pipelined is None:
        pipelined = packed and n > 4 * FULL_EMIT
    if pipelined and packed:
        # Multi-chunk inputs ride the batched corpus pipeline: identical
        # output bits (asserted in tests/test_corpus.py) but with batched
        # device programs and an overlapped fetch/splice pipeline instead of
        # one synchronous dispatch per chunk.
        from ..parallel.corpus import compress_corpus

        # chunk_size passed explicitly: the corpus default binds FULL_EMIT
        # at its own import time, which may postdate a test's monkeypatched
        # value — the call-time global is the source of truth.
        return compress_corpus(data, options, chunk_size=FULL_EMIT)
    emit = SMALL_EMIT if n <= SMALL_EMIT else FULL_EMIT
    # Checksums run on the host (native C slice-by-8, GB/s) — the device
    # CRC tree is a material fraction of encode time and the host holds the
    # bytes anyway.  The sharded pipeline keeps device checksums.
    encoder = get_chunk_encoder(options, emit, with_checksums=False)

    pieces = []
    nbytes_list = []
    asm = BitAssembler(n + n // 128 + 4096) if packed else None
    offsets = list(range(0, n, FULL_EMIT)) if n else [0]
    for off in offsets:
        ln = min(n - off, FULL_EMIT)
        is_last = off + ln >= n
        out = _encode_chunk_host(encoder, data, off, ln, is_last, emit)
        total_bits = int(out["total_bits"])
        if total_bits > out["words"].size * 32:
            raise RuntimeError(
                f"encoder overflow: {total_bits} bits exceeds the "
                f"{out['words'].size * 32}-bit word buffer (bug)"
            )
        if packed:
            splice_encoded_chunk(
                asm, int(out["btype"]), int(out["data_bits"]), out["words"],
                data[off : off + ln], is_last,
            )
        else:
            nbytes_list.append((total_bits + 7) // 8)
            pieces.append(np.asarray(out["words"]).view(np.uint8))

    if packed:
        stream = asm.take_aligned()
    else:
        # Ordered assembly of the variable-length chunk payloads (native C++
        # fast path with a NumPy fallback, runtime/native.py).
        stream = native.assemble_chunks(
            np.stack(pieces), np.asarray(nbytes_list, np.int64)
        )
    return StreamResult(
        deflate=stream,
        adler=native.adler32(data),
        crc32=native.crc32(data),
        isize=n % (1 << 32),
    )


def _resolve(options) -> CompressionOptions:
    if isinstance(options, Compression):
        return CompressionOptions.from_compression(options)
    return options


def deflate_bytes_conf(data: bytes, options) -> bytes:
    """Raw DEFLATE (lib.rs:137-165)."""
    return compress_stream(bytes(data), _resolve(options)).deflate


def deflate_bytes(data: bytes) -> bytes:
    return deflate_bytes_conf(data, CompressionOptions.default())


def deflate_bytes_zlib_conf(data: bytes, options) -> bytes:
    """zlib-framed DEFLATE with big-endian Adler-32 trailer (lib.rs:182-218)."""
    res = compress_stream(bytes(data), _resolve(options))
    return C.zlib_header() + res.deflate + res.adler.to_bytes(4, "big")


def deflate_bytes_zlib(data: bytes) -> bytes:
    return deflate_bytes_zlib_conf(data, CompressionOptions.default())


def deflate_bytes_gzip_conf(data: bytes, builder: GzBuilder, options) -> bytes:
    """gzip member with CRC-32 + ISIZE little-endian trailer (lib.rs:241-286)."""
    res = compress_stream(bytes(data), _resolve(options))
    return (
        builder.header_bytes()
        + res.deflate
        + res.crc32.to_bytes(4, "little")
        + res.isize.to_bytes(4, "little")
    )


def deflate_bytes_gzip(data: bytes) -> bytes:
    return deflate_bytes_gzip_conf(data, GzBuilder(), CompressionOptions.default())
