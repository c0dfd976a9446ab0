"""Unit tests for package-merge code lengths and dynamic-header RLE.

Counterpart of the reference's length_encode.rs tests (optimality vs an
independent Huffman construction, length_encode.rs:619-660; RLE cases
length_encode.rs:440-567) — with our own oracles instead of ported vectors.
"""

import heapq

import numpy as np
import pytest
import jax.numpy as jnp

from deflate_rs_tpu.ops.package_merge import package_merge_lengths
from deflate_rs_tpu.ops.code_lengths import CL_CAP, encode_code_lengths


def huffman_cost_unlimited(freqs):
    """Optimal (unlimited-depth) Huffman cost via a heap — host oracle."""
    items = [f for f in freqs if f > 0]
    if len(items) <= 1:
        return sum(items)  # single symbol: 1 bit each
    heapq.heapify(items)
    total = 0
    while len(items) > 1:
        a, b = heapq.heappop(items), heapq.heappop(items)
        total += a + b
        heapq.heappush(items, a + b)
    return total


def check(freqs, max_len, expect_optimal=True):
    freqs = np.asarray(freqs, dtype=np.int32)
    lengths = np.asarray(package_merge_lengths(jnp.asarray(freqs), max_len))
    used = freqs > 0
    assert (lengths[~used] == 0).all()
    assert (lengths[used] >= 1).all()
    assert (lengths[used] <= max_len).all()
    if used.sum() >= 2:
        # Kraft equality: an optimal length-limited code is complete.
        kraft = np.sum(2.0 ** (-lengths[used].astype(np.float64)))
        assert kraft == pytest.approx(1.0, abs=1e-12)
    cost = int(np.sum(freqs * lengths))
    if expect_optimal and used.sum() >= 2:
        assert cost == huffman_cost_unlimited(freqs.tolist())
    return cost, lengths


def test_simple():
    cost, lengths = check([5, 5, 5, 5], 15)
    assert list(lengths) == [2, 2, 2, 2]


def test_skewed():
    check([1, 1, 2, 4, 8, 16, 32], 15)


def test_single_symbol():
    _, lengths = check([0, 7, 0], 15)
    assert list(lengths) == [0, 1, 0]


def test_empty():
    _, lengths = check([0, 0, 0], 15)
    assert list(lengths) == [0, 0, 0]


def test_two_symbols_extreme():
    _, lengths = check([1, 1000000 >> 4], 15)
    assert list(lengths) == [1, 1]


@pytest.mark.parametrize("seed", range(8))
def test_random_optimal(seed):
    """When the depth limit doesn't bind, package-merge == Huffman optimum."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 286))
    freqs = np.zeros(286, np.int32)
    k = int(rng.integers(2, n + 1))
    idx = rng.choice(286, size=k, replace=False)
    freqs[idx] = rng.integers(1, 5000, size=k)
    check(freqs, 15)


def test_limited_fibonacci():
    """Fibonacci frequencies force deep trees; the 15-bit limit must bind
    while staying within (limited-)optimal cost <= any valid assignment."""
    fib = [1, 1]
    while len(fib) < 25:
        fib.append(fib[-1] + fib[-2])
    freqs = np.array(fib, np.int32)
    lengths = np.asarray(package_merge_lengths(jnp.asarray(freqs), 15))
    assert lengths.max() == 15
    kraft = np.sum(2.0 ** (-lengths[lengths > 0].astype(np.float64)))
    assert kraft <= 1.0 + 1e-12


def test_clen_limit_7():
    rng = np.random.default_rng(11)
    freqs = rng.integers(0, 300, size=19).astype(np.int32)
    lengths = np.asarray(package_merge_lengths(jnp.asarray(freqs), 7))
    assert lengths.max() <= 7


# ------------------------------------------------------------------ RLE


def rle_decode(sym, cnt, n):
    out = []
    prev = None
    for s, c in zip(sym[:n], cnt[:n]):
        if s < 16:
            out.append(int(s))
            prev = int(s)
        elif s == 16:
            out += [out[-1]] * int(c)
        elif s == 17:
            out += [0] * int(c)
        else:
            out += [0] * int(c)
    return out


def rle_roundtrip(cl):
    arr = np.zeros(CL_CAP, np.int32)
    arr[: len(cl)] = cl
    res = encode_code_lengths(jnp.asarray(arr), jnp.int32(len(cl)))
    sym = np.asarray(res["sym"])
    cnt = np.asarray(res["cnt"])
    n = int(res["n"])
    decoded = rle_decode(sym, cnt, n)
    assert decoded == list(cl), (decoded, list(cl))
    # All repeat counts must be within spec ranges.
    for s, c in zip(sym[:n], cnt[:n]):
        if s == 16:
            assert 3 <= c <= 6
        elif s == 17:
            assert 3 <= c <= 10
        elif s == 18:
            assert 11 <= c <= 138
    # Histogram matches emissions.
    freq = np.asarray(res["freq"])
    for v in range(19):
        assert freq[v] == sum(1 for s in sym[:n] if s == v)
    return sym[:n], cnt[:n]


def test_rle_cases():
    rle_roundtrip([5])
    rle_roundtrip([0])
    rle_roundtrip([0, 0])
    rle_roundtrip([0, 0, 0])  # one 17
    rle_roundtrip([0] * 10)
    rle_roundtrip([0] * 11)  # one 18
    rle_roundtrip([0] * 138)
    rle_roundtrip([0] * 139)  # 138 + 1 literal
    rle_roundtrip([0] * 150)  # 138 + 12 (second 18)
    rle_roundtrip([0] * 140)  # 138 + 2 literals
    rle_roundtrip([0] * 145)  # 138 + 7 (17)
    rle_roundtrip([7] * 2)
    rle_roundtrip([7] * 3)
    rle_roundtrip([7] * 4)  # literal + 16(3)
    rle_roundtrip([7] * 7)  # literal + 16(6)
    rle_roundtrip([7] * 8)  # literal + 16(6) + literal
    rle_roundtrip([7] * 9)
    rle_roundtrip([7] * 10)  # literal + 16(6) + 16(3)
    rle_roundtrip([3, 3, 3, 3, 0, 0, 0, 2, 2, 6])
    rle_roundtrip([1, 2, 3, 4, 5])


@pytest.mark.parametrize("seed", range(6))
def test_rle_random(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 316))
    # biased toward runs
    vals = []
    while len(vals) < n:
        v = int(rng.integers(0, 16)) if rng.random() < 0.5 else 0
        vals += [v] * int(rng.integers(1, 20))
    rle_roundtrip(vals[:n])


def test_reference_optimality_vector_7701():
    """The reference's transplanted optimality golden (length_encode.rs:619-660):
    for this frequency table the optimal 15-limited code costs exactly 7701
    bits (value asserted by the reference against miniz's table).  Package-
    merge is exactly optimal, so we must hit 7701 on the nose."""
    freqs = [
        0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 44, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
        0, 0, 0, 68, 0, 14, 0, 0, 0, 0, 3, 7, 6, 1, 0, 12, 14, 9, 2, 6, 9, 4, 1, 1, 4, 1, 1, 0,
        0, 1, 3, 0, 6, 0, 0, 0, 4, 4, 1, 2, 5, 3, 2, 2, 9, 0, 0, 3, 1, 5, 5, 8, 0, 6, 10, 5, 2,
        0, 0, 1, 2, 0, 8, 11, 4, 0, 1, 3, 31, 13, 23, 22, 56, 22, 8, 11, 43, 0, 7, 33, 15, 45,
        40, 16, 1, 28, 37, 35, 26, 3, 7, 11, 9, 1, 1, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
        0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
        0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
        0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
        0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
        0, 0, 1, 126, 114, 66, 31, 41, 25, 15, 21, 20, 16, 15, 10, 7, 5, 1, 1,
    ]
    cost, lengths = check(freqs, 15, expect_optimal=False)
    assert cost == 7701
    assert int(lengths.max()) <= 15


# ---------------------------------------------------------------------------
# Batched package-merge (package_merge_rows), alone and under an outer vmap
# as the batched encoder calls it: every row must equal the single-row
# package_merge_lengths.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("max_len,A", [(15, 286), (7, 19), (15, 30)])
def test_pm_kernel_matches_xla(max_len, A):
    import jax

    from deflate_rs_tpu.ops.package_merge import package_merge_rows

    rng = np.random.default_rng(max_len * 1000 + A)
    R = 130
    freqs = rng.integers(0, 1 << 20, (R, A)).astype(np.int32)
    freqs[rng.random((R, A)) < 0.5] = 0
    freqs[0] = 0  # empty alphabet row
    freqs[1] = 0
    freqs[1, 3] = 7  # single-symbol row
    freqs[2] = 0
    freqs[2, 0] = 1
    freqs[2, A - 1] = 1  # two-symbol row
    freqs[3] = 1  # all-ones (deepest tree pressure)

    want = np.stack([
        np.asarray(package_merge_lengths(jnp.asarray(f), max_len)) for f in freqs
    ])
    rows = np.asarray(package_merge_rows(jnp.asarray(freqs), max_len))
    np.testing.assert_array_equal(rows, want)
    batched = jax.jit(jax.vmap(lambda f: package_merge_rows(f, max_len)))
    got = np.asarray(batched(jnp.asarray(freqs.reshape(2, R // 2, A))))
    np.testing.assert_array_equal(got.reshape(R, A), want)
