"""Profiling and tracing helpers.

The reference's only progress visibility is ``tqdm`` (SURVEY.md §5). Here:
structured per-phase wall timers (they synchronise on device results
before stopping the clock) and a thin wrapper over ``jax.profiler.trace``
for capturing device traces viewable in TensorBoard/Perfetto.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator

import jax

_ACCUM: Dict[str, list] = defaultdict(list)


@contextlib.contextmanager
def phase_timer(name: str, sync: object = None, verbose: bool = True,
                ) -> Iterator[None]:
    """Time a phase; pass device arrays via ``sync`` to block on them."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync is not None:
            jax.block_until_ready(sync)
        dt = time.perf_counter() - t0
        _ACCUM[name].append(dt)
        if verbose:
            print(f"[timer] {name}: {dt:.3f}s", flush=True)


def timings() -> Dict[str, dict]:
    """Accumulated phase statistics: count / total / mean seconds."""
    out = {}
    for name, ts in _ACCUM.items():
        out[name] = {
            "count": len(ts),
            "total_s": sum(ts),
            "mean_s": sum(ts) / len(ts),
        }
    return out


def reset_timings() -> None:
    _ACCUM.clear()


@contextlib.contextmanager
def device_trace(log_dir: str, enabled: bool = True) -> Iterator[None]:
    """Capture a JAX/XLA device trace into ``log_dir`` (TensorBoard format).

    Usage::

        with device_trace("/tmp/shadow_trace"):
            obj.shadow(x, k=1024)
    """
    if not enabled:
        yield
        return
    with jax.profiler.trace(log_dir):
        yield
