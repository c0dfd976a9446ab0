"""Smoke test of the encoder on a GPU, through the library's entry points.

    python chip_smoke.py             # one card: every phase below
    python chip_smoke.py --chips 4   # four cards: the sharded stream only

One card, in order:
  device     the first JAX device is a GPU; the card's name and power limit;
             the native host runtime is loaded; the compile cache's place
  compile    each preset's batched 64 KiB encoder (B=32) and 4 KiB tier:
             compile seconds and memory_analysis(); then one recompile that
             must come from the persistent cache
  goldens    the golden case set under every preset vs the CPU goldens
             (tests/golden.py): roundtrip always, byte-identical or within
             0.1% of the golden length
  bulk       compress_corpus at default on 64 MiB; raw, zlib and gzip
             framing against stdlib; wall seconds and MB/s
  streaming  GzEncoder/ZlibEncoder over 8 MiB with odd write splits: equal
             to one-shot without flush, roundtrip with flushes, reset reuse
  decode     inflate_device on our streams and on stdlib zlib streams
  stages     five plain stages and the whole encoder, jitted and timed
             alone at B=32 x 64 KiB for default and high, ms per chunk

Four cards: make_sharded_encoder over make_mesh(4) on 256 MiB, against the
same data through single-card compress_corpus: byte-identical packed
stream, combined checksums equal to stdlib.

The last line of output is {"ok": true, "device": {...}}; it is printed
only when every phase passed.  Without a GPU the script exits non-zero
before any phase runs.
"""

from __future__ import annotations

import argparse
import functools
import gzip
import io
import json
import os
import sys
import time
import zlib

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "tests"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import deflate_rs_tpu as dt  # noqa: E402
from deflate_rs_tpu import constants as C  # noqa: E402
from deflate_rs_tpu.compression_options import CompressionOptions  # noqa: E402
from deflate_rs_tpu.ops.chunk_encode import (  # noqa: E402
    HALO, PAD, get_batch_encoder, get_chunk_encoder,
)
from deflate_rs_tpu.runtime import native  # noqa: E402
from deflate_rs_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402
from deflate_rs_tpu.utils.profiling import gpu_card, require_gpu, sync_time  # noqa: E402

PRESETS = ("fast", "default", "high", "turbo", "rle", "huffman_only")
FULL, SMALL, B = 65536, 4096, 32


def log(*a):
    print(*a, flush=True)


class CacheEvents:
    """Counts JAX's persistent-cache hits and misses."""

    def __init__(self):
        self.hits = self.misses = 0
        jax.monitoring.register_event_listener(self._on_event)

    def _on_event(self, event, **_):
        if event == "/jax/compilation_cache/cache_hits":
            self.hits += 1
        elif event == "/jax/compilation_cache/cache_misses":
            self.misses += 1


def opts(preset):
    return getattr(CompressionOptions, preset)()


# --------------------------------------------------------------- phases


def phase_device():
    dev = require_gpu("chip_smoke.py")
    card = gpu_card()
    log(f"device: platform={dev.platform} kind={dev.device_kind} "
        f"count={len(jax.devices())} jax={jax.__version__}")
    log(f"card: {card}")
    if not native.available():
        raise RuntimeError("native host runtime (csrc/deflate_runtime.cpp) did not load")
    log(f"native runtime: loaded; compile cache: {enable_compile_cache()}")
    return dev, card


def _arg_structs(emit, batch):
    lead = (batch,) if batch else ()
    return (
        jax.ShapeDtypeStruct(lead + (HALO + emit + PAD,), np.uint8),
        jax.ShapeDtypeStruct(lead, np.int32),
        jax.ShapeDtypeStruct(lead, np.int32),
        jax.ShapeDtypeStruct(lead, np.bool_),
    )


def _programs(preset):
    """The encoder programs the one-card phases call: batched 64 KiB
    (compress_corpus-sized batches), single 64 KiB and 4 KiB (one-shot and
    streaming chunks)."""
    o = opts(preset)
    return (
        (f"{preset} 64KiB x{B}", get_batch_encoder(o, FULL, with_checksums=False),
         _arg_structs(FULL, B)),
        (f"{preset} 64KiB", get_chunk_encoder(o, FULL, with_checksums=False),
         _arg_structs(FULL, 0)),
        (f"{preset} 4KiB", get_chunk_encoder(o, SMALL, with_checksums=False),
         _arg_structs(SMALL, 0)),
    )


def phase_compile(cache, workers=8):
    """Lower every program, then compile them on ``workers`` threads (XLA
    compiles outside the GIL), so a cold start pays about the longest
    compiles instead of their sum."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    lowered = [(name, fn.lower(*args)) for preset in PRESETS
               for name, fn, args in _programs(preset)]
    log(f"lowered {len(lowered)} programs in {time.perf_counter() - t0:.1f} s")

    def compile_one(item):
        name, low = item
        t = time.perf_counter()
        compiled = low.compile()
        return name, time.perf_counter() - t, compiled.memory_analysis()

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=workers) as ex:
        for name, secs, ma in ex.map(compile_one, lowered):
            log(f"compile {name}: {secs:.1f} s; memory: arguments "
                f"{ma.argument_size_in_bytes} B, outputs {ma.output_size_in_bytes} B, "
                f"temp {ma.temp_size_in_bytes} B, code {ma.generated_code_size_in_bytes} B")
    log(f"compiled {len(lowered)} programs in {time.perf_counter() - t0:.1f} s wall "
        f"on {workers} threads")
    # The second compile of a program must come from the persistent cache.
    jax.clear_caches()
    hits = cache.hits
    name, fn, args = _programs(PRESETS[0])[0]
    t0 = time.perf_counter()
    fn.lower(*args).compile()
    hit = cache.hits > hits
    log(f"recompile {name}: {time.perf_counter() - t0:.1f} s, "
        f"persistent cache {'hit' if hit else 'MISS'} "
        f"(hits {cache.hits}, misses {cache.misses} so far)")
    if not hit:
        raise RuntimeError("second compile did not hit the persistent cache")


def phase_goldens():
    import golden

    goldens = golden.load_goldens()
    cases = golden.golden_cases()
    identical = total = 0
    failures = []
    for preset in PRESETS:
        rows = golden.compare_preset(preset, goldens, cases)
        same = sum(r[1] == "identical" for r in rows)
        identical += same
        total += len(rows)
        log(f"goldens {preset}: {same}/{len(rows)} byte-identical")
        for case, verdict, ln, glen in rows:
            if verdict != "identical":
                log(f"  {preset}/{case}: {verdict}, {ln} B vs golden {glen} B "
                    f"({(ln - glen) / max(glen, 1):+.5%})")
            if verdict not in ("identical", "near"):
                failures.append((preset, case, verdict))
    broken = sum(f[2] == "roundtrip" for f in failures)
    log(f"goldens: {identical}/{total} byte-identical to the CPU goldens; "
        f"{total - broken}/{total} roundtrip through stdlib zlib")
    if failures:
        raise RuntimeError(f"golden failures: {failures}")


def phase_bulk(card, mb=64):
    from bench import build_corpus
    from deflate_rs_tpu.models.gzip_header import GzBuilder
    from deflate_rs_tpu.parallel.corpus import compress_corpus

    data = build_corpus(mb << 20)
    o = opts("default")
    warm = compress_corpus(data[: FULL * B], o, batch_size=B)
    assert zlib.decompress(warm.deflate, wbits=-15) == data[: FULL * B]
    t0 = time.perf_counter()
    res = compress_corpus(data, o, batch_size=B)
    secs = time.perf_counter() - t0
    raw = res.deflate
    zl = C.zlib_header() + raw + res.adler.to_bytes(4, "big")
    gz = (GzBuilder().header_bytes() + raw + res.crc32.to_bytes(4, "little")
          + res.isize.to_bytes(4, "little"))
    checks = {
        "raw": zlib.decompress(raw, wbits=-15) == data,
        "zlib": zlib.decompress(zl) == data,
        "gzip": gzip.decompress(gz) == data,
        "adler32": res.adler == zlib.adler32(data),
        "crc32": res.crc32 == zlib.crc32(data),
    }
    log(f"bulk: compress_corpus default, {len(data) >> 20} MiB -> {len(raw)} B "
        f"(ratio {len(raw) / len(data):.4f}) in {secs:.3f} s = "
        f"{len(data) / secs / 1e6:.1f} MB/s on {card}; checks {checks}")
    if not all(checks.values()):
        raise RuntimeError(f"bulk checks failed: {checks}")
    return data


def phase_streaming(data, mb=8):
    from deflate_rs_tpu.models.gzip_header import GzBuilder
    from deflate_rs_tpu.parallel.corpus import compress_corpus_gzip, compress_corpus_zlib

    data = data[: mb << 20]
    o = opts("default")
    # Writes below 64 KiB: the stream encodes chunk by chunk with the
    # single-chunk program the goldens already compiled.
    splits = (1, 997, 65535, 4096, 7, 30011, 65535, 12345)

    def pieces(buf):
        off, k = 0, 0
        while off < len(buf):
            step = splits[k % len(splits)]
            yield buf[off : off + step]
            off, k = off + step, k + 1

    # One-shot reference: the batched corpus path (output is independent of
    # the batch size; B matches the program the bulk phase compiled).
    oneshot = {
        "gzip": compress_corpus_gzip(data, o, builder=GzBuilder(), batch_size=B),
        "zlib": compress_corpus_zlib(data, o, batch_size=B),
    }
    decode = {"gzip": gzip.decompress, "zlib": zlib.decompress}
    for kind, cls in (("gzip", dt.write.GzEncoder), ("zlib", dt.write.ZlibEncoder)):
        sink = io.BytesIO()
        enc = cls(sink, o)
        for p in pieces(data):
            enc.write(p)
        enc.finish()
        same = sink.getvalue() == oneshot[kind]
        sink = io.BytesIO()
        enc.reset(sink)
        for i, p in enumerate(pieces(data)):
            enc.write(p)
            if i % 5 == 4:
                enc.flush()
        enc.finish()
        flushed = decode[kind](sink.getvalue()) == data
        sink = io.BytesIO()
        enc.reset(sink)
        enc.write(data[:100_000])
        enc.finish()
        reused = decode[kind](sink.getvalue()) == data[:100_000]
        log(f"streaming {kind}: {len(data) >> 20} MiB in odd splits; no flush "
            f"== one-shot: {same}; flush every 5 writes roundtrips: {flushed}; "
            f"reset + reuse roundtrips: {reused}")
        if not (same and flushed and reused):
            raise RuntimeError(f"streaming {kind} failed")


def phase_decode():
    from deflate_rs_tpu.ops.inflate_device import inflate_device

    with open(os.path.join(HERE, "tests", "data", "pg11.txt"), "rb") as f:
        text = f.read()
    rng = np.random.default_rng(7)
    contents = {
        "text16k": text[:16384],
        "zeros": b"\x00" * 16000,
        "random": rng.integers(0, 256, 12000, dtype=np.uint8).tobytes(),
    }
    streams = []
    for preset, name in (("default", "text16k"), ("fast", "zeros"), ("high", "random")):
        streams.append((f"ours-{preset}/{name}", contents[name],
                        dt.deflate_bytes_conf(contents[name], opts(preset))))
    for level, name in ((1, "text16k"), (6, "zeros"), (9, "text16k")):
        co = zlib.compressobj(level, zlib.DEFLATED, -15)
        streams.append((f"zlib-{level}/{name}", contents[name],
                        co.compress(contents[name]) + co.flush()))
    for name, want, stream in streams:
        ok = inflate_device(stream, 16384) == want
        log(f"decode {name}: {len(stream)} B -> {len(want)} B, equal: {ok}")
        if not ok:
            raise RuntimeError(f"device decode of {name} differs")


def _real_batch(data, emit=FULL, batch=B):
    raw = np.frombuffer(data[: batch * emit + HALO + PAD], np.uint8)
    bufs = np.stack([raw[i * emit : i * emit + HALO + emit + PAD] for i in range(batch)])
    return (jax.device_put(bufs), jax.device_put(np.full(batch, HALO, np.int32)),
            jax.device_put(np.full(batch, emit, np.int32)),
            jax.device_put(np.zeros(batch, bool)))


def stage_times(preset, bufs, hist, ns, lasts, iters=10):
    """ms per chunk of the five plain stages and the whole encoder, each
    jitted and batched over B chunks alone."""
    from deflate_rs_tpu.ops.chunk_encode import dominant_lengths, hash_matches, jump_steps
    from deflate_rs_tpu.ops.package_merge import package_merge_rows
    from deflate_rs_tpu.ops.parse import token_starts
    from deflate_rs_tpu.ops.symbolmap import histogram_onehot, table_lookup

    o = opts(preset)
    batch = bufs.shape[0]
    E = bufs.shape[1] - HALO - PAD
    N = HALO + E
    nq = o.num_quarters
    QL = E // nq

    def matches(buf, h, n):
        return hash_matches(buf, N, HALO + n, HALO - h, o)

    best_len, best_dist = jax.jit(jax.vmap(matches))(bufs, hist, ns)
    cap = 4 * o.probe_words
    d_cand = jnp.where(best_len >= cap, best_dist, 0)
    lsym = bufs[:, HALO : HALO + E].astype(jnp.int32)
    rng = np.random.default_rng(0)
    dcode = jnp.asarray(rng.integers(0, C.NUM_DIST_SYMBOLS, (batch, E)), jnp.int32)
    valid = jnp.asarray(rng.random((batch, E)) < 0.6)
    rows = 2 * (len([(i, j) for i in range(nq) for j in range(i + 1, nq + 1)])
                if o.exact_split_scoring else nq)
    freqs = jnp.asarray(rng.integers(0, 4000, (batch, rows, C.NUM_USED_LITLEN)), jnp.int32)
    l_tab = jnp.asarray(rng.integers(0, 1 << 21, (batch, nq, C.NUM_LITLEN_SYMBOLS)), jnp.int32)
    d_tab = jnp.asarray(rng.integers(0, 1 << 21, (batch, nq, C.NUM_DIST_SYMBOLS)), jnp.int32)

    def parse(bl, bd, n):
        return token_starts(jump_steps(bl, bd, o), n)

    def longrange(buf, h, n, dc):
        return dominant_lengths(buf, N, HALO + n, HALO - h, dc, o)

    def fields(ls, dc, lt, dtab):
        return [(table_lookup(lt[q], ls[q * QL:(q + 1) * QL], C.NUM_LITLEN_SYMBOLS),
                 table_lookup(dtab[q], dc[q * QL:(q + 1) * QL], C.NUM_DIST_SYMBOLS))
                for q in range(nq)]

    def hists(ls, dc, v):
        return [(histogram_onehot(ls[q * QL:(q + 1) * QL], v[q * QL:(q + 1) * QL],
                                  C.NUM_USED_LITLEN),
                 histogram_onehot(dc[q * QL:(q + 1) * QL], v[q * QL:(q + 1) * QL],
                                  C.NUM_DIST_SYMBOLS))
                for q in range(nq)]

    stages = {
        "matcher": (jax.vmap(matches), (bufs, hist, ns)),
        "jumps+reachable": (jax.vmap(parse), (best_len, best_dist, ns)),
        "package_merge_rows": (jax.vmap(functools.partial(package_merge_rows, max_len=15)),
                               (freqs,)),
        "local_dominant_lengths": (jax.vmap(longrange), (bufs, hist, ns, d_cand)),
        "table_lookup fields": (jax.vmap(fields), (lsym, dcode, l_tab, d_tab)),
        "histogram_onehot": (jax.vmap(hists), (lsym, dcode, valid)),
        "whole encode_chunk": (get_batch_encoder(o, E, with_checksums=False),
                               (bufs, hist, ns, lasts)),
    }
    if not o.use_long_range:
        del stages["local_dominant_lengths"]
    return {name: sync_time(fn, *args, iters=iters) * 1e3 / batch
            for name, (fn, args) in stages.items()}


def phase_stages(data, card, batch=B, iters=10):
    bufs, hist, ns, lasts = _real_batch(data, batch=batch)
    for preset in ("default", "high"):
        ms = stage_times(preset, bufs, hist, ns, lasts, iters=iters)
        log(f"stages {preset} (ms per 64 KiB chunk, B={batch}, {card}): "
            + json.dumps({k: round(v, 4) for k, v in ms.items()}))


# ------------------------------------------------------------ four cards


def sharded_vs_single(mb=256, ndev=4, steps_per_log=32):
    """One stream over an ``ndev``-device mesh vs the single-device corpus
    path on the same data."""
    from bench import build_corpus
    from deflate_rs_tpu.models.assembly import BitAssembler, splice_encoded_chunk
    from deflate_rs_tpu.ops import checksum as ck
    from deflate_rs_tpu.parallel.corpus import compress_corpus
    from deflate_rs_tpu.parallel.mesh import make_mesh
    from deflate_rs_tpu.parallel.sharded import make_sharded_encoder

    o = opts("default")
    data = build_corpus(mb << 20)
    n = len(data)
    arr = np.frombuffer(data, np.uint8)
    step = make_sharded_encoder(make_mesh(ndev), o, FULL, compact=False)
    asm = BitAssembler(n + n // 128 + 4096)
    adler, crc_raw = ck.ADLER_INIT, 0
    nsteps = -(-n // (FULL * B))
    t0 = time.perf_counter()
    for si in range(nsteps):
        base = si * FULL * B
        bufs = np.zeros((B, HALO + FULL + PAD), np.uint8)
        hist = np.zeros(B, np.int32)
        ns = np.zeros(B, np.int32)
        lasts = np.zeros(B, bool)
        for i in range(B):
            off = base + i * FULL
            ln = max(0, min(n - off, FULL))
            h = min(off, HALO) if ln else 0
            bufs[i, HALO - h : HALO] = arr[off - h : off]
            bufs[i, HALO : HALO + ln] = arr[off : off + ln]
            hist[i], ns[i], lasts[i] = h, ln, off + ln >= n
        out = {k: np.asarray(v) for k, v in step(bufs, hist, ns, lasts).items()}
        for i in range(B):
            ln = int(ns[i])
            if ln == 0:
                continue
            off = base + i * FULL
            splice_encoded_chunk(asm, int(out["btype"][i]), int(out["data_bits"][i]),
                                 out["words"][i], data[off : off + ln], bool(lasts[i]))
            adler = ck.adler32_combine(adler, int(out["s1"][i]), int(out["s2"][i]), ln)
            crc_raw = ck.crc32_combine_raw(crc_raw, int(out["crc_raw"][i]), ln)
        if si % steps_per_log == 0 or si == nsteps - 1:
            log(f"  sharded step {si + 1}/{nsteps}")
    sharded = asm.take_aligned()
    t_sharded = time.perf_counter() - t0
    t0 = time.perf_counter()
    single = compress_corpus(data, o, batch_size=B)
    t_single = time.perf_counter() - t0
    checks = {
        "identical": sharded == single.deflate,
        "roundtrip": zlib.decompress(sharded, wbits=-15) == data,
        "adler32": ck.adler32_value(adler) == zlib.adler32(data),
        "crc32": ck.crc32_from_raw(crc_raw, n) == zlib.crc32(data),
    }
    log(f"sharded over {ndev} devices: {n >> 20} MiB -> {len(sharded)} B in "
        f"{t_sharded:.1f} s; single device compress_corpus: {len(single.deflate)} B "
        f"in {t_single:.1f} s (both times include compilation); {checks}")
    if not all(checks.values()):
        raise RuntimeError(f"sharded checks failed: {checks}")


# ------------------------------------------------------------------ main


def timed(name, phase, *args):
    t0 = time.perf_counter()
    out = phase(*args)
    log(f"phase {name}: done in {time.perf_counter() - t0:.1f} s")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4),
                    help="4: run only the sharded stream over four cards")
    args = ap.parse_args(argv)

    dev, card = phase_device()
    if args.chips == 4:
        if len(jax.devices()) < 4:
            raise SystemExit(f"chip_smoke.py: --chips 4 needs 4 GPUs, found {len(jax.devices())}")
        sharded_vs_single()
    else:
        timed("compile", phase_compile, CacheEvents())
        timed("goldens", phase_goldens)
        data = timed("bulk", phase_bulk, card)
        timed("streaming", phase_streaming, data)
        timed("decode", phase_decode)
        timed("stages", phase_stages, data, card)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices()),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
