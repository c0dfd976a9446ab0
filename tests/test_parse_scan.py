"""Unit tests for the parse scan: jump steps + pointer-doubling orbit.

The encoder's parse (``build_jumps`` then ``token_starts``, ops/parse.py)
must reproduce, bit for bit, the sequential parse: the orbit of position 0
under the jump table (the reference's per-byte driver loop shape,
lz77.rs:305-486, re-expressed as jumps).
"""

import jax
import numpy as np
import pytest

from deflate_rs_tpu.constants import MIN_MATCH, TOO_FAR
from deflate_rs_tpu.ops.parse import build_jumps, token_starts

_parse_batched = jax.jit(jax.vmap(token_starts))


def parse_batched(steps, ns):
    return np.asarray(_parse_batched(np.asarray(steps, np.int32), np.asarray(ns, np.int32)))


def serial_parse(steps, n):
    """The ground truth: walk the jump chain from 0."""
    out = np.zeros(len(steps), bool)
    p = 0
    while p < n:
        out[p] = True
        p += int(steps[p])
    return out


def serial_lazy_parse(best_len, best_dist, n, lazy_if_less_than):
    """Sequential lazy parse straight from the matcher output (the rule of
    ops/parse.py's docstring, walked one decision at a time)."""
    E = len(best_len)
    length = np.where((best_len == MIN_MATCH) & (best_dist > TOO_FAR), 0, best_len)
    out = np.zeros(E, bool)
    p = 0
    while p < n:
        out[p] = True
        ln = int(length[p])
        nxt = int(length[p + 1]) if p + 1 < E else 0
        if ln >= MIN_MATCH and not (ln < lazy_if_less_than and nxt > ln):
            p += ln
        else:
            p += 1
    return out


def make_matches(rng, E, match_frac=0.3, max_len=258):
    best_len = np.zeros(E, np.int32)
    is_m = rng.random(E) < match_frac
    best_len[is_m] = rng.integers(3, max_len + 1, is_m.sum())
    best_dist = rng.integers(1, 32769, E).astype(np.int32)
    return best_len, best_dist


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("nfrac", [1.0, 0.55, 0.0, 0.013])
def test_parse_scan_matches_serial(seed, nfrac):
    E = 512
    rng = np.random.default_rng(seed)
    B = 3
    thr = 32
    mats = [make_matches(rng, E) for _ in range(B)]
    steps = np.stack([
        np.asarray(build_jumps(bl, bd, lazy=True, lazy_if_less_than=thr))
        for bl, bd in mats
    ])
    ns = np.full(B, int(E * nfrac), np.int32)
    got = parse_batched(steps, ns)
    for b in range(B):
        want = serial_lazy_parse(*mats[b], ns[b], thr)
        assert (got[b] == want).all(), f"chunk {b} parse mismatch"
        assert (got[b] == serial_parse(steps[b], ns[b])).all()


def test_parse_scan_all_literals_and_all_long():
    E = 512
    B = 2
    steps = np.stack([
        np.ones(E, np.int32),                 # every position a literal
        np.full(E, 258, np.int32),            # maximal jumps everywhere
    ])
    ns = np.array([E, E], np.int32)
    got = parse_batched(steps, ns)
    for b in range(B):
        want = serial_parse(steps[b], ns[b])
        assert (got[b] == want).all()


def test_parse_scan_segment_boundary_overhangs():
    """Jumps engineered to straddle every 32-position boundary."""
    E, L = 512, 32
    steps = np.ones(E, np.int32)
    # Place a match just before each boundary jumping deep into the next one.
    for s in range(1, E // L):
        steps[s * L - 3] = 40
    got = parse_batched(steps[None], np.array([E], np.int32))[0]
    want = serial_parse(steps, E)
    assert (got == want).all()
