"""The token-field lookups (``symbolmap.table_lookup``) must equal a plain
gather bit for bit: the packed bitstream depends on these fields exactly.

Packed Huffman entries (code | length << 16) reach ~2**21, so the one-hot
dot must run at full float32 precision (a TF32 or bf16 pass would round
them).
"""

import numpy as np
import pytest
import jax.numpy as jnp

from deflate_rs_tpu.ops.symbolmap import table_lookup


@pytest.mark.parametrize("nq", [1, 4])
def test_field_kernel_matches_xla(nq):
    rng = np.random.default_rng(nq + 10)
    E = 2048
    QL = E // nq
    for num in (288, 30):
        idx = rng.integers(0, num, E).astype(np.int32)
        # One table per quarter, as the encoder codes each quarter with its
        # owning block's tables: code (<= 15 bits) | len (1..15) << 16, plus
        # the extreme entries just under 2**21.
        tables = (rng.integers(0, 1 << 15, (nq, num))
                  | (rng.integers(1, 16, (nq, num)) << 16)).astype(np.int32)
        tables[:, 0] = (1 << 21) - 1
        tables[:, -1] = (15 << 16) | 0x7FFF
        idx[:3] = [0, num - 1, 0]
        for q in range(nq):
            sl = slice(q * QL, (q + 1) * QL)
            got = np.asarray(table_lookup(jnp.asarray(tables[q]), jnp.asarray(idx[sl]), num))
            np.testing.assert_array_equal(got, tables[q][idx[sl]], err_msg=f"num={num} q={q}")
