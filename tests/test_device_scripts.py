"""The GPU scripts refuse to run without a GPU, and the compile cache has
one fixed place."""

import os
import subprocess
import sys

import jax
import pytest

from deflate_rs_tpu.utils import compile_cache
from deflate_rs_tpu.utils.profiling import require_gpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_require_gpu_refuses_cpu_device():
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(SystemExit, match="no GPU found"):
        require_gpu("chip_smoke.py")


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_script_exits_without_gpu(script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, script)], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert "no GPU found" in proc.stderr
    assert proc.stdout.strip() == "", proc.stdout  # no timing, no result line


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # nothing set


def test_compile_cache_default_is_fixed_repo_path(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    try:
        path = compile_cache.enable_compile_cache()
        assert path == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
        assert compile_cache.enable_compile_cache() == path  # same every call
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
