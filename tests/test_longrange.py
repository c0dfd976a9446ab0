"""Unit tests for ops/longrange.py — exact run lengths, never overclaiming."""

import numpy as np
import pytest

import jax.numpy as jnp

from deflate_rs_tpu.ops.longrange import local_dominant_lengths


def brute_run(data: bytes, i: int, d: int, n_total: int, hstart: int) -> int:
    """Longest l with data[i+t] == data[i+t-d] for t < l (within bounds)."""
    if d <= 0 or i - d < hstart:
        return 0
    l = 0
    while i + l < n_total and data[i + l] == data[i + l - d] and l < 258:
        l += 1
    return l


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_claims_exact_vs_brute_force(seed):
    rng = np.random.default_rng(seed)
    N = 2048
    S, M = 8, 4
    # Repetitive content with a few planted long copies at varied distances.
    base = rng.integers(97, 123, N // 4, dtype=np.uint8)
    data = np.tile(base, 4).astype(np.uint8)
    for (src, dst, ln) in ((100, 700, 300), (40, 1500, 258), (900, 1203, 97)):
        data[dst : dst + ln] = data[src : src + ln]
    pad = np.zeros(300, np.uint8)
    buf = jnp.asarray(np.concatenate([data, pad]))
    n_total, hstart = N, 0

    # Candidates: the planted distances plus noise, position-major.
    d_cand = np.zeros(N, np.int32)
    d_cand[700:1000:7] = 600
    d_cand[1500:1750:5] = 1460
    d_cand[1203:1280:3] = 303
    d_cand[::31] = 512  # mostly-invalid noise distance

    b_len, b_dist = local_dominant_lengths(
        buf, N, jnp.int32(n_total), jnp.int32(hstart), jnp.asarray(d_cand),
        num_dom=M, num_seg=S,
    )
    b_len = np.asarray(b_len)
    b_dist = np.asarray(b_dist)
    raw = bytes(data)
    for i in range(N):
        if b_len[i] > 0:
            true = brute_run(raw, i, int(b_dist[i]), n_total, hstart)
            # Claims must be exact byte runs at the claimed distance (the
            # cost model and the emitted stream both rely on them).
            assert b_len[i] <= true, (i, int(b_len[i]), true, int(b_dist[i]))
            # And byte-exact unless clipped by MAX_MATCH/limit.
            assert b_len[i] == min(true, 258, n_total - i), (
                i, int(b_len[i]), true)


def test_planted_copy_recovered_full_length():
    """A 258-byte copy at a dominant distance must be claimed in full."""
    rng = np.random.default_rng(3)
    N = 4096
    data = rng.integers(0, 256, N, dtype=np.uint8)
    data[2000:2258] = data[400:658]
    buf = jnp.asarray(np.concatenate([data, np.zeros(300, np.uint8)]))
    d_cand = np.zeros(N, np.int32)
    d_cand[2000:2100] = 1600
    b_len, b_dist = local_dominant_lengths(
        buf, N, jnp.int32(N), jnp.int32(0), jnp.asarray(d_cand),
        num_dom=4, num_seg=8,
    )
    assert int(b_len[2000]) == 258
    assert int(b_dist[2000]) == 1600


def test_no_claims_outside_validity():
    """Positions whose source crosses hstart or end get no claims."""
    N = 1024
    data = np.tile(np.arange(32, dtype=np.uint8), N // 32)
    buf = jnp.asarray(np.concatenate([data, np.zeros(300, np.uint8)]))
    d_cand = np.full(N, 32, np.int32)
    hstart = 512
    b_len, b_dist = local_dominant_lengths(
        buf, N, jnp.int32(N), jnp.int32(hstart), jnp.asarray(d_cand),
        num_dom=2, num_seg=4,
    )
    b_len = np.asarray(b_len)
    assert (b_len[: hstart + 32] == 0).all()  # source would cross hstart
    assert (b_len[hstart + 32 : N - 3] >= 3).any()


def assert_claims_exact(data, b_len, b_dist, n_total, hstart):
    """Every claim is an exact byte run at its distance: never longer than
    the true run, and equal to it unless clipped by MAX_MATCH or the end."""
    b_len = np.asarray(b_len)
    b_dist = np.asarray(b_dist)
    raw = bytes(data)
    for i in np.nonzero(b_len)[0]:
        true = brute_run(raw, int(i), int(b_dist[i]), n_total, hstart)
        assert b_len[i] == min(true, 258, n_total - i), (
            int(i), int(b_len[i]), true, int(b_dist[i]))


def _planted_case():
    """Repetitive text with three planted long copies, and a harvest that
    names their distances plus a noise distance."""
    rng = np.random.default_rng(7)
    N = 4096
    base = rng.integers(32, 127, N // 8, dtype=np.uint8)
    data = np.tile(base, 8).astype(np.uint8)
    for (src, dst, ln) in ((64, 1100, 258), (500, 2100, 300), (40, 3803, 97)):
        data[dst : dst + ln] = data[src : src + ln]
    buf = jnp.asarray(np.concatenate([data, np.zeros(4200, np.uint8)]))
    d_cand = np.zeros(N, np.int32)
    d_cand[1100:1350:3] = 1036
    d_cand[2100:2390:5] = 1600
    d_cand[3803:3890:2] = 3763
    d_cand[::17] = 700
    return N, data, buf, d_cand


def test_kernel_path_matches_xla_formulation():
    """local_dominant_lengths on the planted-copy case: every claim is exact
    (brute force) and the planted copies are claimed in full."""
    N, data, buf, d_cand = _planted_case()
    b_len, b_dist = local_dominant_lengths(
        buf, N, jnp.int32(N), jnp.int32(0), jnp.asarray(d_cand),
        num_dom=6, num_seg=8,
    )
    assert_claims_exact(data, b_len, b_dist, N, 0)
    b_len = np.asarray(b_len)
    b_dist = np.asarray(b_dist)
    assert b_len[1100] == 258 and b_dist[1100] == 1036
    assert b_len[2100] == 258 and b_dist[2100] == 1600


def test_kernel_density_gating_edges():
    """Segments with ZERO live dominants (empty harvest) and segments with
    every slot live, mixed in one chunk: the selection keeps the live
    dominants a prefix, and every claim is exact (brute force)."""
    from deflate_rs_tpu.ops.longrange import _select_dominants

    rng = np.random.default_rng(11)
    N = 4096
    S, M = 8, 4
    data = np.tile(rng.integers(32, 127, N // 8, dtype=np.uint8), 8)
    data[1100:1400] = data[64:364]
    buf = jnp.asarray(np.concatenate([data, np.zeros(4200, np.uint8)]))
    d_cand = np.zeros(N, np.int32)
    # Segment 2 (positions 1024..1535): MORE distinct distances than M.
    # The true distance (1036) appears twice per period so it wins top-M by
    # FREQUENCY (selection tie-breaks among equal frequencies are a policy
    # detail — they prefer the larger distance).
    d_cand[1100:1400] = np.asarray([1036, 1037, 1036, 1039, 1040])[
        np.arange(300) % 5
    ]
    # All other segments: empty harvest -> zero live dominants.
    doms, topf = _select_dominants(jnp.asarray(d_cand), S, M)
    doms = np.asarray(doms)
    topf = np.asarray(topf)
    # Dead slots are masked to 0 and live ones form a prefix per segment.
    assert (doms[topf == 0] == 0).all()
    live = doms != 0
    assert (np.diff(live.astype(int), axis=1) <= 0).all(), "live not a prefix"
    assert (live[2].sum()) == M and live[[0, 1, 3, 4, 5, 6, 7]].sum() == 0

    b_len, b_dist = local_dominant_lengths(
        buf, N, jnp.int32(N), jnp.int32(0), jnp.asarray(d_cand),
        num_dom=M, num_seg=S,
    )
    assert_claims_exact(data, b_len, b_dist, N, 0)
    assert int(np.asarray(b_len)[1100]) == 258  # the copy is claimed
    # Segments without live dominants claim nothing.
    assert not np.asarray(b_len)[:1024].any()


def test_run_selection_invariants_and_equivalence():
    """The "run" selection policy (one full-width sort; longest contiguous
    run per distance) keeps dead slots 0, live dominants a prefix, no
    duplicate distances — and local_dominant_lengths under it still claims
    only exact runs (brute force)."""
    from deflate_rs_tpu.ops.longrange import _select_dominants

    # Adversarial interleaving: one distance in many length-1 runs crowds
    # the pre-dedup window — run selection keeps it ONCE (deduped) and the
    # live set stays a clean prefix.  (The freq policy sees 4 distinct
    # dominants here; that fidelity difference is why the high preset
    # resolves lr_sel="freq" — compression_options.resolved_lr_sel.)
    d_cand = np.zeros(4096, np.int32)
    d_cand[1100:1400] = np.asarray([1036, 1037, 1036, 1039, 1040])[
        np.arange(300) % 5
    ]
    doms, topf = _select_dominants(jnp.asarray(d_cand), 8, 4, sel="run")
    doms = np.asarray(doms)
    topf = np.asarray(topf)
    assert (doms[topf == 0] == 0).all()
    live = doms != 0
    assert (np.diff(live.astype(int), axis=1) <= 0).all(), "live not a prefix"
    for row in doms:
        nz = row[row != 0]
        assert len(set(nz.tolist())) == len(nz), "duplicate dominant"

    # Contiguous runs rank by their length: a 40-long run must beat
    # shorter ones into slot 0.
    d2 = np.zeros(4096, np.int32)
    d2[100:140] = 900   # run of 40
    d2[200:210] = 1200  # run of 10
    d2[300:304] = 1500  # run of 4
    doms2, topf2 = _select_dominants(jnp.asarray(d2), 8, 4, sel="run")
    assert np.asarray(doms2)[0, 0] == 900
    assert np.asarray(topf2)[0, 0] == 40
    assert set(np.asarray(doms2)[0][:3].tolist()) == {900, 1200, 1500}

    # Exact claims under the run policy on the planted-copy case.
    N, data, buf, d_cand3 = _planted_case()
    b_len, b_dist = local_dominant_lengths(
        buf, N, jnp.int32(N), jnp.int32(0), jnp.asarray(d_cand3),
        num_dom=6, num_seg=8, sel="run",
    )
    assert_claims_exact(data, b_len, b_dist, N, 0)
    assert int(np.asarray(b_len)[2100]) == 258
