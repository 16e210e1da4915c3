"""Profiling & timing utilities.

The reference's only instrumentation is wall-clock time around each run
(``src/train.py:459,498-499``). Here (SURVEY.md §5.1): honest per-step
timing with ``block_until_ready`` fencing, plus ``jax.profiler`` trace
capture for kernel-level inspection.
"""

from __future__ import annotations

import contextlib
import sys
import time
from typing import Callable, Optional

import jax
import numpy as np


def measurement_device() -> dict:
    """The device a measurement runs on, as JAX reports it, for printing
    beside every number. Exits the process with status 1 when JAX finds
    no GPU: a time taken on another backend is not this program's
    measurement. Turns the persistent compile cache on as well."""
    from allset_tpu.utils.compile_cache import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"{sys.argv[0]}: measurements need a GPU; JAX found "
              f"{dev.platform!r}", file=sys.stderr)
        raise SystemExit(1)
    enable_compile_cache()
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": jax.device_count()}


def time_fn(fn: Callable, *args, iters: int = 10, warmup: int = 2):
    """Median/min/mean seconds per call, each ended by block_until_ready."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    t = np.asarray(times)
    return {
        "median_s": float(np.median(t)),
        "min_s": float(t.min()),
        "mean_s": float(t.mean()),
        "iters": iters,
    }


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a jax.profiler trace viewable in TensorBoard/Perfetto."""
    with jax.profiler.trace(log_dir):
        yield log_dir


class StepTimer:
    """Lightweight running stats for host-side loops (HAN trainer etc.)."""

    def __init__(self):
        self.times = []
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.times.append(time.perf_counter() - self._t0)

    def summary(self):
        t = np.asarray(self.times) if self.times else np.zeros(1)
        return {"mean_s": float(t.mean()), "std_s": float(t.std()), "n": len(self.times)}
