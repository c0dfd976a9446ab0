"""Golden streams: a fixed case set and the SHA-256 + length of every
preset's output for it, computed on the CPU and kept in
``tests/data/golden_streams.json``.

The CPU tests (tests/test_golden.py) hold the encoder to these bytes, and
``chip_smoke.py`` compares the GPU's output with them.  Regenerate, on the
CPU, after a change that is meant to alter the output:

    python tests/golden.py --write
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import zlib

import numpy as np

DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
GOLDEN_PATH = os.path.join(DATA_DIR, "golden_streams.json")
PRESETS = ("fast", "default", "high", "turbo", "rle", "huffman_only")
# A stream that is not byte-identical may still pass on another device if
# its length is within this fraction of the golden's (a float op that
# rounds differently can move a block split; the stream stays valid).
LENGTH_TOLERANCE = 0.001


def golden_cases() -> dict[str, bytes]:
    """The case set: edge sizes, the 64 KiB chunk seams, runs, random and
    periodic content, text/binary alternation and two AFL inputs; each case
    is at most ~80 KB."""
    rng = np.random.default_rng(42)
    with open(os.path.join(DATA_DIR, "pg11.txt"), "rb") as f:
        text = f.read()
    cases = {
        "empty": b"",
        "one": b"x",
        "four": b"abca",
        "text_3k": text[:3000],
        "boundary_65535": text[:65535],
        "boundary_65536": text[:65536],
        "boundary_65537": text[:65537],
        "zeros_65537": b"\x00" * 65537,
        "random_70k": rng.integers(0, 256, 70_000, dtype=np.uint8).tobytes(),
        "high_bytes_70k": rng.integers(144, 256, 70_000, dtype=np.uint8).tobytes(),
        "period_7": b"exampl7" * 10_000,
        "alt_text_bin": (text[:8192] + rng.integers(0, 256, 8192, dtype=np.uint8).tobytes()) * 5,
        "small_alphabet": rng.integers(0, 4, 70_000, dtype=np.uint8).tobytes(),
    }
    afl_dir = os.path.join(DATA_DIR, "afl")
    for name in sorted(os.listdir(afl_dir))[:2]:
        with open(os.path.join(afl_dir, name), "rb") as f:
            cases[f"afl_{name[:9]}"] = f.read()
    return cases


def encode(preset: str, data: bytes) -> bytes:
    import deflate_rs_tpu as dt

    return dt.deflate_bytes_conf(data, getattr(dt.CompressionOptions, preset)())


def digest(stream: bytes) -> list:
    return [hashlib.sha256(stream).hexdigest(), len(stream)]


def load_goldens() -> dict:
    with open(GOLDEN_PATH) as f:
        return json.load(f)


def compare_preset(preset: str, goldens: dict | None = None,
                   cases: dict | None = None) -> list[tuple[str, str, int, int]]:
    """Encode every case under ``preset`` and compare with the goldens.

    Returns (case, verdict, length, golden length) per case, where verdict
    is "identical", "near" (not identical, length within LENGTH_TOLERANCE),
    "far" (length off by more), or "roundtrip" (stdlib zlib does not give
    the input back — always a failure).
    """
    goldens = goldens or load_goldens()
    cases = cases or golden_cases()
    rows = []
    for name, data in cases.items():
        stream = encode(preset, data)
        sha, glen = goldens[preset][name]
        if zlib.decompress(stream, wbits=-15) != data:
            verdict = "roundtrip"
        elif digest(stream) == [sha, glen]:
            verdict = "identical"
        elif abs(len(stream) - glen) <= LENGTH_TOLERANCE * glen:
            verdict = "near"
        else:
            verdict = "far"
        rows.append((name, verdict, len(stream), glen))
    return rows


def main(argv):
    if argv[1:] != ["--write"]:
        print(__doc__)
        return 2
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, os.path.dirname(os.path.dirname(DATA_DIR)))
    import jax

    assert jax.devices()[0].platform == "cpu", "goldens are computed on the CPU"
    cases = golden_cases()
    out = {p: {name: digest(encode(p, data)) for name, data in cases.items()}
           for p in PRESETS}
    with open(GOLDEN_PATH, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {GOLDEN_PATH}: {len(PRESETS)} presets x {len(cases)} cases")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
