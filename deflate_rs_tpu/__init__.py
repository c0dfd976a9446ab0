"""deflate_rs_tpu — a DEFLATE/zlib/gzip encoder built on JAX/XLA.

A from-scratch reimagining of the capabilities of ``image-rs/deflate-rs``
(see SURVEY.md): stored/fixed/dynamic blocks, greedy/lazy/RLE LZ77 matching,
per-block dynamic Huffman construction with exact block-type cost selection,
streaming write/flush/finish semantics, and combinable Adler-32/CRC-32 —
reformulated as data-parallel device pipelines over independent 64 KiB chunks.

Public API mirrors the reference's crate root (lib.rs:98-99, 137-286).
"""

from .compression_options import (
    Compression,
    CompressionOptions,
    MatchingType,
    SpecialOptions,
)
from .models.deflate import (
    deflate_bytes,
    deflate_bytes_conf,
    deflate_bytes_gzip,
    deflate_bytes_gzip_conf,
    deflate_bytes_zlib,
    deflate_bytes_zlib_conf,
)
from .models.gzip_header import GzBuilder
from .models.inflate import inflate, inflate_gzip, inflate_zlib
from . import write

__all__ = [
    "Compression",
    "CompressionOptions",
    "MatchingType",
    "SpecialOptions",
    "GzBuilder",
    "deflate_bytes",
    "deflate_bytes_conf",
    "deflate_bytes_zlib",
    "deflate_bytes_zlib_conf",
    "deflate_bytes_gzip",
    "deflate_bytes_gzip_conf",
    # Decode surface — beyond the reference (it delegates decoding to
    # miniz_oxide in tests and ships none): a spec-complete host inflate
    # for all three framings.  The batched on-device decoder lives in
    # ops/inflate_device.py for on-device validation pipelines.
    "inflate",
    "inflate_zlib",
    "inflate_gzip",
    "write",
]

__version__ = "0.1.0"
