"""Utilities: profiling / tracing, the compilation cache."""
from shadowing_tpu.utils.compile_cache import enable_compile_cache
from shadowing_tpu.utils.profiling import (
    device_trace,
    phase_timer,
    reset_timings,
    timings,
)
