"""Constant-table handling policy.

* a **NumPy** array used as a jnp operand is embedded into the lowered module
  directly from host memory;
* a **jax.Array** constant costs a device->host readback *at every lowering*
  (``_array_mlir_constant_handler`` fetches ``._value``) — seconds per table
  over the slow host link of the encoder's first target device; not yet
  measured on the GPU;
* passing tables as *arguments* avoids embedding entirely.

Policy: all DEFLATE tables stay as module-level NumPy arrays and enter traced
code as raw numpy operands (``jnp.take(np_table, idx)`` for gathers — a bare
``np_table[tracer]`` would hit NumPy's indexing).  ``dev_const`` is the
documented chokepoint so the policy lives in one place.
"""

from __future__ import annotations

import numpy as np


def dev_const(arr) -> np.ndarray:
    """Return the table as a host NumPy constant (see module docstring)."""
    return np.asarray(arr)
