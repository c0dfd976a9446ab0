"""Compression level / option presets.

Mirrors the reference's configuration surface one-to-one
(compression_options.rs:31-196): the same four knobs with the same names and
preset values, so levels are directly comparable.

The vectorized matcher interprets ``max_hash_checks`` as the number of hash
bucket candidates probed per position (the first K links of the equivalent
hash chain), capped at a static width.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

HIGH_MAX_HASH_CHECKS = 1768
HIGH_LAZY_IF_LESS_THAN = 128
MAX_HASH_CHECKS = 32 * 1024
DEFAULT_MAX_HASH_CHECKS = 128
DEFAULT_LAZY_IF_LESS_THAN = 32

# Static cap on the vectorized candidate width; chain positions beyond this
# are rarely profitable and cost K-proportional probe bandwidth.  Measured on
# pg11: K=128 (default preset) already beats zlib -6, K=256 beats zlib -9.
KERNEL_MAX_CANDIDATES = 256


class MatchingType(enum.Enum):
    """Whether to use lazy or greedy matching (lz77.rs:27)."""

    Greedy = "greedy"
    Lazy = "lazy"


class SpecialOptions(enum.Enum):
    """Special compression strategies (compression_options.rs:52-59).

    Unlike the reference (which reserves but does not implement them), both
    force modes are functional here.
    """

    Normal = "normal"
    ForceFixed = "force_fixed"
    ForceStored = "force_stored"


class Compression(enum.Enum):
    """Simplified compression level selector (compression_options.rs:31-42)."""

    Fast = "fast"
    Default = "default"
    Best = "best"


@dataclass(frozen=True)
class CompressionOptions:
    """Tunable compression settings (compression_options.rs:78-120)."""

    max_hash_checks: int = DEFAULT_MAX_HASH_CHECKS
    lazy_if_less_than: int = DEFAULT_LAZY_IF_LESS_THAN
    matching_type: MatchingType = MatchingType.Lazy
    special: SpecialOptions = SpecialOptions.Normal
    # Internal knob set by the corpus path (parallel/corpus.py): candidate
    # budget compensation for device chunks larger than 64 KiB.  The
    # suffix-order matcher's neighborhoods dilute with chunk size (more
    # out-of-window positions share a prefix); scale = chunk_size / 64Ki
    # restores in-window coverage.  Not part of the user-facing preset
    # surface; leave at 1 unless you know the chunk size.
    chain_scale: int = 1
    # Block-split composition scoring policy: "auto" resolves per preset
    # (see exact_split_scoring), "exact"/"proxy" pin it.  Internal knob —
    # not part of the reference-mirroring preset surface.
    split_scoring: str = "auto"
    # Number of content words used as SORT KEYS in the suffix-order matcher
    # (0 = per-preset default, see resolved_sort_nkey).  Fewer keys sort
    # only a shorter content prefix and leave ties in position (recency)
    # order — a ratio/speed axis that is also a ratio WIN for greedy K=1
    # (recency order prefers near candidates: pg11 fast 68741 at nk=1 vs
    # 71639 at nk=4).  Internal knob — not part of the reference-mirroring
    # preset surface.
    sort_nkey: int = 0
    # Intra-chunk block splitting: "auto" resolves per preset (off for the
    # fast family — see num_quarters), "on"/"off" pin it, or a number ("8")
    # pins the static sub-quarter count directly.  Internal knob.
    block_split: str = "auto"
    # Long-range recovery pass (ops/longrange.py): recovers full-length
    # matches on highly redundant inputs where probe-capped tie-breaking
    # starves the extensions.  "auto": on for every chain-budget preset
    # except the fast family; it is what makes Default <= zlib-6 on every
    # in-image corpus (tests/test_corpora_ratio.py).  Internal knob.
    long_range: str = "auto"
    # Probe window width override in 4-byte words (0 = per-preset default,
    # see probe_words).  Internal knob for tuning sweeps.
    probe_words_override: int = 0
    # Dominant-distance count for the long-range exact-length pass
    # (ops/longrange.py local_dominant_lengths); 0 = per-preset default
    # (see resolved_num_dom).  Internal knob.
    num_dom: int = 0
    # Segment count for the local dominant-distance pass (ops/longrange.py
    # local_dominant_lengths); 0 = default (16).  Internal knob.
    dom_segs: int = 0
    # Rounds of the local dominant-distance pass; 0 = default (1).  A second
    # round harvests the distances the first round's claims exposed.
    dom_iters: int = 0
    # Global-union long-range variant (ops/longrange.py
    # global_dominant_lengths): per-segment top-num_dom distances are
    # unioned into this many static slots, each measured over the WHOLE
    # chunk with gather-free contiguous slices — the budgeted form the
    # default preset can afford (the per-segment window slices of the local
    # variant are a ~1000-row gather, measured as its device wall).
    # 0 = use the local variant.
    lr_global: int = 0
    # Harvest subsample stride for the dominant count (capped claims arrive
    # in runs, so a strided sample preserves the frequency ranking at
    # 1/stride the selection-sort cost).  0 = per-preset default.
    lr_stride: int = 0
    # Dominant-selection policy for the long-range pass ("auto"/"run"/
    # "freq", longrange._select_dominants).  "auto": "run" for the
    # default-tier (sa) presets — one full-width sort instead of two, the
    # LR pass's largest XLA stage — and "freq" for the high preset, whose
    # ratio contract should not carry longest-run ranking's interleaved-
    # harvest worst case (a distance split into R runs can crowd the
    # top-M window; real-corpus margins hold at S=64 but high squeezes
    # the last 0.1%).  Internal knob.
    lr_sel: str = "auto"
    # Log-step tail for the suffix-order scan (matching.sa_scan_xla): log2
    # jump sizes appended after the dense scan, reaching exponentially
    # deeper tie-group candidates with exact LCP.  "auto" resolves per
    # preset; "off" disables; or a comma list like "4,5,6,7".  Internal.
    sa_tail: str = "auto"

    @staticmethod
    def default() -> "CompressionOptions":
        return CompressionOptions()

    @staticmethod
    def high() -> "CompressionOptions":
        """Roughly the HIGH(9) setting in miniz (compression_options.rs:126-133)."""
        return CompressionOptions(
            max_hash_checks=HIGH_MAX_HASH_CHECKS,
            lazy_if_less_than=HIGH_LAZY_IF_LESS_THAN,
            matching_type=MatchingType.Lazy,
        )

    @staticmethod
    def fast() -> "CompressionOptions":
        """Fast settings (compression_options.rs:141-148)."""
        return CompressionOptions(
            max_hash_checks=1, lazy_if_less_than=0, matching_type=MatchingType.Greedy
        )

    @staticmethod
    def huffman_only() -> "CompressionOptions":
        """Huffman-coding only, no match search (compression_options.rs:155-162)."""
        return CompressionOptions(
            max_hash_checks=0, lazy_if_less_than=0, matching_type=MatchingType.Greedy
        )

    @staticmethod
    def turbo() -> "CompressionOptions":
        """Maximum-throughput tier (beyond the reference's surface): one
        dynamic-Huffman block per chunk, entropy-proxy scored, no match
        search: the fewest stages of any preset (huffman_only scores
        splits exactly over nq=4 quarters).  Same
        legal-DEFLATE output class as huffman_only; ~2.6x the ratio of
        Default on text (entropy-only).  Use when the input
        is nearly incompressible or the pipeline is throughput-bound."""
        return CompressionOptions(
            max_hash_checks=0, lazy_if_less_than=0,
            matching_type=MatchingType.Greedy, split_scoring="proxy",
            block_split="1",
        )

    @staticmethod
    def rle() -> "CompressionOptions":
        """Run-length (distance 1) matching only (compression_options.rs:171-178)."""
        return CompressionOptions(
            max_hash_checks=0, lazy_if_less_than=0, matching_type=MatchingType.Lazy
        )

    @staticmethod
    def from_compression(level: "Compression") -> "CompressionOptions":
        return {
            Compression.Fast: CompressionOptions.fast(),
            Compression.Default: CompressionOptions.default(),
            Compression.Best: CompressionOptions.high(),
        }[level]

    # --- static kernel configuration -------------------------------------

    @property
    def matcher_mode(self) -> str:
        """'none' (huffman only), 'rle', or 'hash' — lz77.rs:192-232 dispatch."""
        if self.max_hash_checks == 0:
            # max_hash_checks == 0 + Lazy selects RLE mode, matching the
            # reference's special case (compression_options.rs:104-110).
            return "rle" if self.matching_type == MatchingType.Lazy else "none"
        return "hash"

    @property
    def matcher_algo(self) -> str:
        """'sa' (bounded suffix sort) or 'hash' (hash sort + K-probe).

        The suffix-order matcher (matching.py find_matches) reaches hash-
        matcher ratio at half the scan budget and ~30% less device time, so
        it serves every budget up to 2x the kernel candidate cap.  Budgets
        beyond that (the high preset's 1768) select the recency-ordered
        hash matcher (find_matches_hash): its most-recent-K candidate policy
        squeezes out the last ~0.1% that suffix-order tie-grouping loses,
        which is the high preset's contract.
        """
        return "hash" if self.max_hash_checks > 2 * KERNEL_MAX_CANDIDATES else "sa"

    @property
    def num_candidates(self) -> int:
        """Matcher scan depth from the reference's chain-walk budget.

        For 'sa': K neighbors are scanned on BOTH sides in suffix order, so
        a budget of ``max_hash_checks`` chain links maps to K = budget/2 —
        and every budgeted check is a full-quality running-min LCP check,
        unlike the reference's early-exit chain walk.  Measured on pg11:
        SA K=64 beats the hash matcher at K=128, which beats zlib -6.
        For 'hash': the budget itself, capped.
        """
        if self.matcher_algo == "hash":
            return max(1, min(self.max_hash_checks, KERNEL_MAX_CANDIDATES))
        return max(
            1,
            min(self.max_hash_checks * self.chain_scale, KERNEL_MAX_CANDIDATES) // 2,
        )

    @property
    def probe_words(self) -> int:
        """Probe window width in 4-byte words (matching.py).

        Match lengths are exact up to 4*probe_words bytes; chain extension
        recovers longer constant-distance runs.  Probe cost is linear in
        width: 6 words keeps default under zlib -6, high needs 16 to stay
        under zlib -9.  Large corpus chunks (chain_scale > 1) get +2 words:
        with diluted suffix neighborhoods, deeper exact measurement recovers
        the ratio the 64 KiB baseline gets from proximity (measured:
        256 KiB chunks at PW=8/K=128 beat both the 64 KiB baseline and
        zlib -6 on repeated-pg11).
        """
        if self.probe_words_override:
            # Probe word w reads packed[4w : N+4w]; the chunk buffer carries
            # PAD = 72 tail bytes (chunk_encode.PAD), so 4*PW <= PAD + 1
            # => PW <= 18.  Out-of-range overrides previously surfaced as a
            # confusing unequal-shapes sort error from inside the matcher
            # (found in the round-5 high sweep) — fail loudly here instead.
            if not 1 <= self.probe_words_override <= 18:
                raise ValueError(
                    f"probe_words_override={self.probe_words_override}: must "
                    "be in [1, 18] (probe reads are bounded by the chunk "
                    "buffer's 72-byte tail padding)"
                )
            return self.probe_words_override
        if self.fast_family:
            # K=1 greedy only ever compares adjacent suffix-order rows;
            # 16-byte probes buy little there (pg11: 68985 at PW=4 vs 68741
            # at PW=6, both far under zlib-1) and each probe word is a sort
            # operand.
            return 4
        base = 16 if self.max_hash_checks > DEFAULT_MAX_HASH_CHECKS else 6
        if base == 6 and self.chain_scale > 1:
            return 8
        return base

    @property
    def lazy(self) -> bool:
        return self.matching_type == MatchingType.Lazy and self.lazy_if_less_than > 0

    @property
    def exact_split_scoring(self) -> bool:
        """Score block-split compositions with exact package-merge token
        costs (ops/chunk_encode.py).  ``auto`` policy: the high preset gets
        exact because its contract is squeezing the last ~0.1% of ratio;
        huffman_only/rle get it because their all-literal histograms make
        the entropy proxy noticeably lossier (60 B on pg11) and they are
        not throughput presets.  fast/default use the proxy, which skips
        the package-merge over every range for a few bytes per chunk.

        The throughput presets are identified DIRECTLY (an sa-matcher
        "hash" mode) rather than through tuning thresholds, and the
        ``split_scoring`` field overrides the policy outright — retuning
        matcher cutoffs must not silently flip scoring and shift the
        ratio pins (tests/test_ratio.py PG11_GOLDEN_CEILINGS)."""
        if self.split_scoring != "auto":
            return self.split_scoring == "exact"
        throughput_preset = self.matcher_mode == "hash" and self.matcher_algo == "sa"
        return not throughput_preset

    @property
    def fast_family(self) -> bool:
        """Greedy presets with a tiny chain budget — the reference's fast is
        1 hash check, greedy (compression_options.rs:141-148).  Their
        contract is throughput; several knobs below resolve cheaper for
        them.  huffman_only (0 checks) is matcher_mode 'none', not this."""
        return (
            self.matcher_mode == "hash"
            and self.matching_type == MatchingType.Greedy
            and self.max_hash_checks <= 4
        )

    @property
    def num_quarters(self) -> int:
        """Static sub-quarter count for intra-chunk block splitting.

        The fast family opts out of splitting: the quarter machinery
        (per-range histogram prefix sums, composition scoring, per-quarter
        header field segments) is a large share of the fast pipeline's device
        time for a few bytes of ratio (pg11: 68985 split-off vs 68315
        split-on at the fast matcher config — both far under zlib-1's 72095).

        Chain-budget presets split at 8 KiB seams (nq=8, 128 compositions) —
        the round-4 granularity step toward the reference re-tabling every
        <= 31744 tokens at content boundaries (output_writer.rs:19,
        compress.rs:186-247).  Measured vs nq=4: -400..-660 B on ELF
        corpora, -5,043 B (5.2%) on 8 KiB text/binary alternation (where
        nq=4 default LOSES to zlib-6), +60 B on pg11; exact scoring then
        pays R=36 ranges instead of 10.  nq=16 measured <0.4% further gain
        for another doubling of the machinery — not taken.  rle/huffman_only
        keep nq=4 (no matcher; their split value is content-shift entropy
        only).
        """
        if self.block_split not in ("auto", "on", "off"):
            nq = int(self.block_split)
            # Validate HERE, not via the encoder's assert (which disappears
            # under ``python -O``): quarter slicing requires nq to divide
            # every emit size, and every supported emit size is a power of
            # two >= 4096, so require a power of two in [1, 32].
            if nq < 1 or nq > 32 or (nq & (nq - 1)) != 0:
                raise ValueError(
                    f"block_split={self.block_split!r}: numeric override "
                    "must be a power of two in [1, 32]"
                )
            return nq
        if self.block_split != "auto":
            return 4 if self.block_split == "on" else 1
        if self.fast_family:
            return 1
        return 8 if self.matcher_mode == "hash" else 4

    @property
    def use_long_range(self) -> bool:
        """Resolve the long-range recovery knob (see long_range)."""
        if self.long_range != "auto":
            return self.long_range == "on"
        # Every chain-budget preset except the throughput (fast) family.
        return self.matcher_mode == "hash" and not self.fast_family

    @property
    def resolved_sa_tail(self) -> tuple:
        """Log-step tail schedule for the sa matcher (see sa_tail)."""
        if self.sa_tail == "off":
            return ()
        if self.sa_tail != "auto":
            return tuple(int(x) for x in self.sa_tail.split(","))
        if self.fast_family or self.matcher_algo != "sa":
            return ()
        # Dense-K scans a ~K-row neighborhood; the tail reaches the far side
        # of crowded tie groups (repeated JSON keys / license boilerplate)
        # at 8 extra steps: depths K+16 .. K+4080.
        return (4, 5, 6, 7, 8, 9, 10, 11)

    @property
    def resolved_num_dom(self) -> int:
        """Dominant-distance count for the long-range pass (see num_dom).

        48 for both tiers as of round 5.  high (hash matcher): the corpora
        sweep saturated there (M64, S64, x3 measured identical).  default
        (sa): M=32 held the 128 KiB contract but broke it at larger caps
        (tar_tree@512K 1.0010, doc_text@1M 1.0004 — found by the round-5
        margin table); M=48 closes both AND widens the 128 KiB margins
        (json 0.9879 -> 0.9604, sqlite -> 0.9870)."""
        if self.num_dom:
            return self.num_dom
        return 48

    @property
    def resolved_dom_segs(self) -> int:
        """Segment count for the long-range pass (see dom_segs).

        default (sa matcher): 64 — the round-5 contract fix.  The tar_tree
        corpus (512-byte-aligned tar headers over mixed text/binary) broke
        the r4 default contract at 1.0017 of zlib-6; S=64 + harvest stride
        1 with run-based dominant selection closes it (0.9994) and
        improves every other corpus (json_cfg 0.9883 -> 0.9950 under the
        cheaper run selection, sqlite_db -> 0.9872).  Shorter segments are
        also what keeps longest-run ranking faithful to frequency ranking
        (runs interleave less).
        high (hash matcher): 32 — its sweep saturated there (r4)."""
        if self.dom_segs:
            return self.dom_segs
        return 32 if self.matcher_algo == "hash" else 64

    @property
    def resolved_dom_iters(self) -> int:
        if self.dom_iters:
            return self.dom_iters
        return 2 if self.matcher_algo == "hash" else 1

    @property
    def resolved_lr_stride(self) -> int:
        """Harvest subsample stride for the long-range pass (see lr_stride).

        Round 5: stride 1 everywhere — the run-based dominant selection
        (longrange._select_dominants sel="run") deleted the ascending
        value sort, so the full-width harvest costs one [S, LC] sort
        instead of two at twice the width, and the stride-2 fidelity loss
        (part of the r4 tar_tree contract hole) is gone."""
        if self.lr_stride:
            return self.lr_stride
        return 1

    @property
    def resolved_lr_sel(self) -> str:
        """Dominant-selection policy (see lr_sel)."""
        if self.lr_sel != "auto":
            return self.lr_sel
        return "freq" if self.matcher_algo == "hash" else "run"

    @property
    def resolved_lr_pair(self) -> bool:
        """Pair-collapse the harvest before dominant selection (longrange.
        _select_dominants pair=True): halves the selection sort's width
        while keeping isolated claims a stride-2 subsample drops — the
        round-5 measurement showed the default contract (tar_tree) hinges
        on exactly those.  On for every stride-1 preset: the high sweep
        measured contract-clean under it too (worst z9 margin 0.9963,
        pg11 golden unchanged at 60102, json_cfg -1 B) and its freq
        selection pays TWO full-width sorts per dom_iters round."""
        return self.resolved_lr_stride == 1

    @property
    def resolved_sort_nkey(self) -> int:
        """Sort-key count for the suffix-order matcher (see sort_nkey)."""
        if self.sort_nkey:
            return self.sort_nkey
        return 1 if self.fast_family else min(4, self.probe_words)

    def cache_key(self) -> tuple:
        return (
            self.matcher_mode,
            self.matcher_algo,
            self.num_candidates,
            self.probe_words,
            self.resolved_sort_nkey,
            self.lazy,
            min(self.lazy_if_less_than, 258),
            self.special.value,
            self.exact_split_scoring,
            self.num_quarters,
            self.use_long_range,
            (self.resolved_num_dom, self.resolved_dom_segs,
             self.resolved_dom_iters, self.lr_global, self.resolved_lr_stride,
             self.resolved_lr_sel, self.resolved_lr_pair)
            if self.use_long_range else (0, 0, 0, 0, 0, "", False),
            self.resolved_sa_tail,
        )
