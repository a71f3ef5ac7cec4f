"""Throughput metering and profiling hooks.

The reference has zero observability (SURVEY section 5: <chrono> included
but never used). The BASELINE metric is rays/s/chip, so timing is a
first-class utility here: walls are measured around block_until_ready, and
jax.profiler traces can be captured around any rendered region.
"""

from __future__ import annotations

import contextlib
import time

import jax


def time_fn(fn, *args, warmup: int = 1, iters: int = 3, **kwargs):
    """Time a device computation properly (compile excluded, device-synced).

    Returns (best_seconds, last_result).
    """
    result = None
    for _ in range(max(1, warmup)):
        result = jax.block_until_ready(fn(*args, **kwargs))
    best = float("inf")
    for _ in range(max(1, iters)):
        t0 = time.perf_counter()
        result = jax.block_until_ready(fn(*args, **kwargs))
        best = min(best, time.perf_counter() - t0)
    return best, result


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Capture a jax.profiler trace (view with tensorboard/xprof)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class RaysPerSecond:
    """Accumulating rays/s meter."""

    def __init__(self):
        self.rays = 0
        self.seconds = 0.0

    def add(self, rays: int, seconds: float):
        self.rays += rays
        self.seconds += seconds

    @property
    def value(self) -> float:
        return self.rays / self.seconds if self.seconds > 0 else 0.0
