"""Batched one-shot compression for large corpora.

The plain one-shot API (models/deflate.py) encodes chunk-by-chunk, which is
dispatch-bound for large inputs.  This path stages many 64 KiB chunks at
once, runs the vmapped encoder (one device program per batch), assembles with
the native runtime, and combines checksum partials — the single-chip version
of the sharded pipeline in parallel/sharded.py and the engine behind
bench.py's headline number.
"""

from __future__ import annotations

import collections
import functools
import math
import os
import time

import numpy as np

from .. import constants as C
from ..compression_options import Compression, CompressionOptions
from ..models.assembly import BitAssembler, splice_encoded_chunk
from ..models.deflate import FULL_EMIT, StreamResult, _resolve
from ..models.gzip_header import GzBuilder
from ..ops.chunk_encode import HALO, PAD, encode_chunk
from ..ops.compaction import (
    compact_words_device, used_words_device, used_words_host,
)
from ..runtime import native


@functools.lru_cache(maxsize=None)
def _corpus_encoder(options: CompressionOptions, emit_size: int):
    """Batched encoder returning (stacked int32 meta, word buffer).

    Stacking [total_bits, btype, data_bits] into one (3, B) array means the
    host pays ONE small synchronizing fetch per batch instead of three.
    """
    import jax
    import jax.numpy as jnp

    fn = functools.partial(
        encode_chunk, emit_size=emit_size, options=options, with_checksums=False
    )

    def run(bufs, hist, ns, lasts):
        out = jax.vmap(fn)(bufs, hist, ns, lasts)
        meta = jnp.stack(
            [out["total_bits"], out["btype"], out["data_bits"]]
        ).astype(jnp.int32)
        return meta, out["words"]

    return jax.jit(run)


@functools.lru_cache(maxsize=None)
def _corpus_encoder_flat(options: CompressionOptions, emit_size: int, batch: int):
    """Batched encoder over a FLAT payload upload with on-device halo windows.

    The host uploads exactly batch*emit_size payload bytes; each chunk's
    32 KiB history halo is sliced on device from the previous chunk's
    payload tail (the previous *batch's* tail rides along as a small
    device-resident carry, never fetched).  This removes the +12.5% halo
    re-upload and the host-side staging copies.

    PAD tail bytes are zeros for every chunk, matching the host-staging
    layout bit-for-bit (so corpus output stays byte-identical to the
    one-shot path at the default chunk size).
    """
    import jax
    import jax.numpy as jnp

    E = emit_size
    fn = functools.partial(
        encode_chunk, emit_size=E, options=options, with_checksums=False,
        # The compacted fetch never reads a stored chunk's device words
        # (used = 0; the splicer re-emits them from the raw payload), so the
        # encoder skips their E/4 pack fields entirely.
        stored_payload_fields=False,
    )

    def run(payload, prev_tail, hist, ns, lasts):
        P = payload.reshape(batch, E)
        halos = jnp.concatenate([prev_tail[None], P[:-1, E - HALO :]], axis=0)
        pads = jnp.zeros((batch, PAD), jnp.uint8)
        bufs = jnp.concatenate([halos, P, pads], axis=1)
        out = jax.vmap(fn)(bufs, hist, ns, lasts)
        meta = jnp.stack(
            [out["total_bits"], out["btype"], out["data_bits"]]
        ).astype(jnp.int32)
        # Device-side used-prefix compaction (ops/compaction.py — the one
        # shared definition): fetch only the words the splicer will
        # actually read — ceil(data_bits/32) per Huffman chunk,
        # ZERO for stored chunks (the host re-emits those from the raw
        # payload it already holds; models/assembly.py).
        words = out["words"]
        NW = words.shape[1]
        compact = compact_words_device(words, used_words_device(meta[1], meta[2]))
        # Two static pieces instead of one buffer: the host fetches the
        # first unconditionally and the second only when the batch's used
        # words exceed CAP (ratio > ~0.5 net of stored chunks — rare).
        # Static outputs avoid dispatching a dynamic slice program from the
        # fetch worker, which would serialize the pipeline behind queued
        # encodes.
        cap = (batch * NW) // 2
        return meta, compact[:cap], compact[cap:], P[-1, E - HALO :]

    return jax.jit(run)


def chunk_grain(options: CompressionOptions) -> int:
    """The step that ``compress_corpus``'s ``chunk_size`` must be a multiple of.

    The encoder packs the emit region into 4-byte words (the API's floor of
    16 covers that), slices it into ``num_quarters`` split ranges, and the
    long-range pass cuts HALO + chunk into ``resolved_dom_segs`` segments of
    whole words (``longrange``'s ``N % (4 * num_seg)``).  HALO is a multiple
    of each of these, so the chunk alone must be.
    """
    grain = math.lcm(16, options.num_quarters)
    if options.use_long_range:
        grain = math.lcm(grain, 4 * options.resolved_dom_segs)
    return grain


def compress_corpus(
    data: bytes,
    options: CompressionOptions | Compression | None = None,
    *,
    batch_size: int = 16,
    packed: bool = True,
    queue_depth: int = 3,
    chunk_size: int = FULL_EMIT,
) -> StreamResult:
    """Compress ``data`` as one DEFLATE stream using batched device encodes.

    ``packed`` bit-splices blocks marker-free on the host (identical output
    to ``models.deflate.compress_stream``); ``packed=False`` keeps every
    chunk byte-aligned behind a sync marker (the device-assembly framing).

    The device work is pipelined: up to ``queue_depth`` batches stay in
    flight (JAX dispatch is asynchronous and device execution is FIFO), so
    host-side fetch + bit splicing of batch i overlaps device encode of
    batches i+1..i+queue_depth.  Wall time approaches
    max(device total, host total) instead of their sum.

    ``chunk_size`` is the per-device-call block granularity (the analogue of
    pigz's block size).  The default matches the one-shot path byte-exactly;
    larger chunks (e.g. 262144) amortize the fixed 32 KiB history halo and
    per-chunk table construction over more payload — ~25% less device work
    per byte at 256 KiB.  Must be a positive multiple of
    :func:`chunk_grain` (16 to 256 for the presets).

    The suffix-order matcher's candidate neighborhoods dilute as the chunk
    grows (more out-of-window positions share a content prefix), so the
    chain budget is scaled linearly with the chunk size (capped at the
    kernel limit) to keep in-window candidate coverage constant — measured
    on repeated-pg11: 256 KiB chunks at the scaled budget beat both the
    64 KiB baseline and zlib -6.
    """
    import jax

    options = _resolve(options or CompressionOptions.default())
    n = len(data)
    E = int(chunk_size)
    grain = chunk_grain(options)
    if E <= 0 or E % grain:
        raise ValueError(
            f"chunk_size must be a positive multiple of {grain} for these options, got {E}"
        )
    if E > FULL_EMIT and options.max_hash_checks:
        import dataclasses

        options = dataclasses.replace(options, chain_scale=max(1, E // FULL_EMIT))
    # Host-side native checksums (see compress_stream); skip the device ones.
    # flat_mode needs E-byte tails for the device-side halo windows, and its
    # compacted output drops stored chunks' words (the packed splicer
    # re-emits those from the raw payload) — packed=False needs full rows,
    # so it keeps the legacy host-staging encoder.
    flat_mode = E >= HALO and packed
    encoder = None if flat_mode else _corpus_encoder(options, E)

    offsets = list(range(0, n, E)) if n else [0]
    arr = np.frombuffer(data, np.uint8) if n else np.zeros(0, np.uint8)

    pieces = []
    nbytes_all = []
    asm = BitAssembler(n + n // 128 + 4096) if packed else None
    # Fetch pipeline (shaped for a slow host link; not yet measured on the
    # GPU): the synchronizing meta wait AND the ragged words
    # fetch both run on worker threads (plain blocking device_get), so the
    # main thread only dispatches device work and splices finished batches, in
    # FIFO order.  Device execution is FIFO and JAX dispatch is async, so
    # batches i+1..i+queue_depth compute under the fetches of batch i.
    import threading
    from concurrent.futures import ThreadPoolExecutor

    pool = ThreadPoolExecutor(max_workers=2)
    fetch_q = collections.deque()  # (group, ns, lasts, future) in flight

    trace = os.environ.get("DEFLATE_TPU_TRACE_CORPUS") == "1"
    tstats = {"meta_s": 0.0, "words_s": 0.0, "words_mb": 0.0, "join_s": 0.0, "splice_s": 0.0}
    tlock = threading.Lock()  # two fetch workers update tstats concurrently

    def _tadd(key, v):
        with tlock:
            tstats[key] += v

    def fetch_batch(meta_d, words_d):
        t0 = time.perf_counter() if trace else 0.0
        meta = np.asarray(meta_d)  # (3, B) — the synchronizing fetch
        if trace:
            _tadd("meta_s", time.perf_counter() - t0)
        # Fetch only what the splicer reads.  flat_mode: the device compacted every chunk's used
        # word prefix (zero for stored chunks) into one flat buffer; fetch
        # its used prefix.  Legacy mode: ragged-max row slice.
        # The slice itself is a device program that queues behind any
        # already-dispatched encode batches (device FIFO), so slicing trades
        # transfer bytes for queue latency; skippable for measurement.
        if flat_mode:
            head_d, rest_d = words_d
            used = used_words_host(meta[1], meta[2])
            need = int(used.sum())
            t0 = time.perf_counter() if trace else 0.0
            words = np.asarray(head_d)
            if need > words.shape[0]:
                words = np.concatenate([words, np.asarray(rest_d)])
            if trace:
                _tadd("words_s", time.perf_counter() - t0)
                _tadd("words_mb", words.nbytes / 1e6)
            return meta, words, used
        if os.environ.get("DEFLATE_TPU_FETCH_SLICE", "1") == "0" or not packed:
            # packed=False feeds fixed-stride rows to native.assemble_chunks;
            # per-batch ragged slicing would give batches different widths.
            src = words_d
        else:
            need = max(1, (int(meta[0].max()) + 31) // 32)
            maxw = words_d.shape[1]
            while maxw // 2 >= need:
                maxw //= 2
            src = words_d[:, :maxw]
        t0 = time.perf_counter() if trace else 0.0
        words = np.asarray(src)
        if trace:
            _tadd("words_s", time.perf_counter() - t0)
            _tadd("words_mb", words.nbytes / 1e6)
        return meta, words, None

    def drain_one():
        group, ns_h, lasts_h, fut = fetch_q.popleft()
        t0 = time.perf_counter() if trace else 0.0
        meta, words, used = fut.result()
        if trace:
            tstats["join_s"] += time.perf_counter() - t0
            t0 = time.perf_counter()
        if flat_mode:
            woff = np.cumsum(used) - used
            bwords = words.view(np.uint8)
            for i, off in enumerate(group):
                stored = int(meta[1, i]) == C.BTYPE_STORED
                splice_encoded_chunk(
                    asm, int(meta[1, i]), int(meta[2, i]),
                    bwords[4 * woff[i] : 4 * (woff[i] + used[i])],
                    # The splicer reads the payload only for stored chunks;
                    # skip the up-to-chunk-size bytes copy everywhere else.
                    data[off : off + ns_h[i]] if stored else b"", lasts_h[i],
                )
        else:
            words = words.view(np.uint8).reshape(len(ns_h), -1)
            for i, off in enumerate(group):
                if packed:
                    stored = int(meta[1, i]) == C.BTYPE_STORED
                    splice_encoded_chunk(
                        asm, int(meta[1, i]), int(meta[2, i]), words[i],
                        data[off : off + ns_h[i]] if stored else b"", lasts_h[i],
                    )
                else:
                    nbytes_all.append((int(meta[0, i]) + 7) // 8)
            if not packed:
                pieces.append(words[: len(group)])
        if trace:
            tstats["splice_s"] += time.perf_counter() - t0

    prev_tail = np.zeros(HALO, np.uint8) if flat_mode else None
    try:
        for base in range(0, len(offsets), batch_size):
            group = offsets[base : base + batch_size]
            # Pad the tail batch to full width: one compiled shape for the
            # whole run.
            B = batch_size if len(offsets) > batch_size else len(group)
            hist = np.zeros(B, np.int32)
            ns = np.zeros(B, np.int32)
            lasts = np.zeros(B, bool)
            for i, off in enumerate(group):
                ln = min(n - off, E)
                hist[i], ns[i], lasts[i] = min(off, HALO), ln, off + ln >= n
            if flat_mode:
                lo, hi = group[0], group[0] + B * E
                if hi <= n:
                    payload = arr[lo:hi]  # zero-copy view; device_put copies once
                else:
                    payload = np.zeros(B * E, np.uint8)
                    payload[: n - lo] = arr[lo:]
                # Explicit async upload: the H2D copy streams while the
                # previous batches compute / fetch, instead of blocking
                # inside dispatch.
                payload = jax.device_put(payload)
                meta_d, head_d, rest_d, prev_tail = _corpus_encoder_flat(
                    options, E, B
                )(payload, prev_tail, hist, ns, lasts)
                words_d = (head_d, rest_d)
            else:
                bufs = np.zeros((B, HALO + E + PAD), np.uint8)
                for i, off in enumerate(group):
                    h, ln = int(hist[i]), int(ns[i])
                    if h:
                        bufs[i, HALO - h : HALO] = arr[off - h : off]
                    if ln:
                        bufs[i, HALO : HALO + ln] = arr[off : off + ln]
                meta_d, words_d = encoder(bufs, hist, ns, lasts)
            fetch_q.append(
                (
                    group,
                    [int(x) for x in ns],
                    [bool(x) for x in lasts],
                    pool.submit(fetch_batch, meta_d, words_d),
                )
            )
            if len(fetch_q) > queue_depth:
                drain_one()
        while fetch_q:
            drain_one()
    finally:
        # A drain/fetch error must not leak the worker threads or keep
        # queued futures pinning device buffers in a long-lived process.
        pool.shutdown(cancel_futures=True)
    if trace:
        import sys

        print(
            "corpus trace: "
            + " ".join(f"{k}={v:.3f}" for k, v in tstats.items()),
            file=sys.stderr,
        )

    if packed:
        stream = asm.take_aligned()
    else:
        stream = native.assemble_chunks(
            np.concatenate(pieces, axis=0), np.asarray(nbytes_all, np.int64)
        )
    return StreamResult(
        deflate=stream,
        adler=native.adler32(data),
        crc32=native.crc32(data),
        isize=n % (1 << 32),
    )


def compress_corpus_zlib(data: bytes, options=None, *, batch_size: int = 16) -> bytes:
    res = compress_corpus(data, options, batch_size=batch_size)
    return C.zlib_header() + res.deflate + res.adler.to_bytes(4, "big")


def compress_corpus_gzip(
    data: bytes, options=None, *, builder: GzBuilder | None = None, batch_size: int = 16
) -> bytes:
    res = compress_corpus(data, options, batch_size=batch_size)
    return (
        (builder or GzBuilder()).header_bytes()
        + res.deflate
        + res.crc32.to_bytes(4, "little")
        + res.isize.to_bytes(4, "little")
    )
