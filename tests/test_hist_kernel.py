"""The per-quarter histograms (``symbolmap.histogram_onehot``) must equal
``np.bincount`` over the valid positions, bit for bit."""

import numpy as np
import pytest
import jax.numpy as jnp

from deflate_rs_tpu import constants as C
from deflate_rs_tpu.ops.symbolmap import histogram_onehot


@pytest.mark.parametrize("nq", [1, 4])
def test_hist_kernel_matches_onehot(nq):
    rng = np.random.default_rng(nq)
    E = 4096
    QL = E // nq
    # Realistic mix: mostly literals (0..255), some length syms (257..285),
    # invalid positions masked out by ``valid``.
    lsym = rng.integers(0, C.NUM_USED_LITLEN, E).astype(np.int32)
    lvalid = rng.random(E) >= 0.4
    dcode = rng.integers(0, C.NUM_DIST_SYMBOLS, E).astype(np.int32)
    dvalid = rng.random(E) >= 0.7
    for q in range(nq):
        sl = slice(q * QL, (q + 1) * QL)
        lf = histogram_onehot(jnp.asarray(lsym[sl]), jnp.asarray(lvalid[sl]), C.NUM_USED_LITLEN)
        df = histogram_onehot(jnp.asarray(dcode[sl]), jnp.asarray(dvalid[sl]), C.NUM_DIST_SYMBOLS)
        np.testing.assert_array_equal(
            np.asarray(lf), np.bincount(lsym[sl][lvalid[sl]], minlength=C.NUM_USED_LITLEN))
        np.testing.assert_array_equal(
            np.asarray(df), np.bincount(dcode[sl][dvalid[sl]], minlength=C.NUM_DIST_SYMBOLS))
