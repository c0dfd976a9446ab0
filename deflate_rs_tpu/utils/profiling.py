"""Device identification and timing for the scripts that run on a GPU.

* :func:`require_gpu` — the first JAX device, or exit: no script that
  measures the card falls back to the CPU;
* :func:`gpu_card` — the card's name and power limit as ``nvidia-smi``
  reports them (a child process that does not use JAX);
* :func:`sync_time` — host clock around work that ends in
  ``block_until_ready``.
"""

from __future__ import annotations

import subprocess
import time

import jax


def require_gpu(who: str):
    """Return ``jax.devices()[0]`` if it is a GPU, else exit non-zero."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"{who}: no GPU found (JAX platform is {dev.platform!r}); "
            "this script runs only on a GPU"
        )
    return dev


def gpu_card() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def sync_time(fn, *args, iters: int = 5, warmup: bool = True):
    """Seconds per call of ``jax.jit(fn)(*args)``, compile excluded (a
    function that is already jitted is used as it is).

    JAX returns before the device finishes, so the outputs are waited on
    with ``block_until_ready`` before the clock stops; executions on one
    device run in order, so the last call's outputs finish last.
    """
    jitted = fn if hasattr(fn, "lower") else jax.jit(fn)
    compiled = jitted.lower(*args).compile()
    if warmup:
        jax.block_until_ready(compiled(*args))
    t0 = time.perf_counter()
    out = None
    for _ in range(iters):
        out = compiled(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters
