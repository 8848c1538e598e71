"""Profiling utilities and the compilation-cache location."""
from pathlib import Path

import numpy as np
import pytest

from shadowing_tpu.utils.profiling import (
    device_trace,
    phase_timer,
    reset_timings,
    timings,
)


def test_phase_timer_accumulates():
    reset_timings()
    with phase_timer("unit", verbose=False):
        _ = np.arange(10).sum()
    with phase_timer("unit", verbose=False):
        _ = np.arange(10).sum()
    t = timings()
    assert t["unit"]["count"] == 2
    assert t["unit"]["total_s"] >= t["unit"]["mean_s"]
    reset_timings()
    assert timings() == {}


def test_device_trace_disabled_noop(tmp_path):
    with device_trace(str(tmp_path), enabled=False):
        pass  # must not create trace files
    assert list(tmp_path.iterdir()) == []


def test_device_trace_captures(tmp_path):
    import jax.numpy as jnp

    with device_trace(str(tmp_path)):
        jnp.arange(16).sum().block_until_ready()
    assert any(tmp_path.rglob("*"))  # trace artifacts written


@pytest.mark.parametrize("env", [None, "given"])
def test_compile_cache_dir(tmp_path, monkeypatch, env):
    """JAX_COMPILATION_CACHE_DIR, when set, is used as it is and nothing is
    configured; otherwise the cache goes to the fixed in-checkout
    directory (listed in .gitignore), never to a per-run path."""
    import jax

    from shadowing_tpu.utils import compile_cache

    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, val: calls.append((name, val)))
    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        got = compile_cache.enable_compile_cache()
        repo = Path(__file__).resolve().parents[1]
        assert got == str(repo / "_jax_cache")
        assert calls == [("jax_compilation_cache_dir", got)]
        assert "_jax_cache/" in (repo / ".gitignore").read_text().split()
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert compile_cache.enable_compile_cache() == str(tmp_path)
        assert calls == []
