"""Benchmark timing harness.

The reference repeats the kernel in-device ``rp_time`` times and divides the
wall time (src/sextans-host.cpp:223,237-252; src/sextans.cpp:53-57). Here the
repeats are chained through a data dependency (C fed back in) so the device
cannot overlap them, and every timed region ends in ``block_until_ready``:
JAX returns before the device finishes, so a timing without it measures the
enqueue.
"""

from __future__ import annotations

import time
from typing import Callable

import jax
import numpy as np

__all__ = ["time_call", "time_chained", "time_repeat", "time_repeat_chained"]


def time_call(fn: Callable, *args, reps: int = 20):
    """``(first_call_seconds, median_seconds, result)`` of ``fn(*args)``.

    The first call includes tracing and compilation; the median is over
    ``reps`` further calls, each ended by ``block_until_ready``."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    walls = []
    for _ in range(max(reps, 1)):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        walls.append(time.perf_counter() - t0)
    return first, float(np.median(walls)), out


def time_chained(
    step: Callable[[jax.Array], jax.Array],
    c0: jax.Array,
    rp_time: int = 10,
    warmup: int = 2,
) -> float:
    """Time ``step`` (C -> C') chained ``rp_time`` times; returns seconds/call.

    ``step`` must consume and produce an array of the same shape so the chain
    forms a true data dependency (the rp_time loop of src/sextans.cpp:54-60).
    """
    c = c0
    for _ in range(warmup):
        c = step(c)
    jax.block_until_ready(c)
    c = c0
    t0 = time.perf_counter()
    for _ in range(rp_time):
        c = step(c)
    jax.block_until_ready(c)
    return (time.perf_counter() - t0) / max(rp_time, 1)


def _result(secs, times, method, detail):
    if detail:
        return secs, {"method": method, "times": times}
    return secs


def time_repeat(plan, b, alpha, beta, c0, times: int = 10,
                detail: bool = False):
    """Seconds per kernel invocation of ``plan.repeat`` (the in-device
    rp_time chain, one dispatch); with ``detail=True`` returns
    ``(seconds, info)``. The first call compiles and is not timed."""
    times = max(times, 1)
    jax.block_until_ready(plan.repeat(b, alpha, beta, c0, times=times))
    t0 = time.perf_counter()
    jax.block_until_ready(plan.repeat(b, alpha, beta, c0, times=times))
    secs = (time.perf_counter() - t0) / times
    return _result(secs, times, "repeat", detail)


def time_repeat_chained(plan, b, alpha, beta, c0, times: int = 10,
                        detail: bool = False):
    """``time_repeat`` for plans without an in-device repeat program:
    ``times`` single calls chained through C on the host. Dispatch overhead
    rides on every step, so this can only overestimate."""
    times = max(times, 1)
    jax.block_until_ready(plan(b, alpha, beta, c0))
    t0 = time.perf_counter()
    c = c0
    for _ in range(times):
        c = plan(b, alpha, beta, c)
    jax.block_until_ready(c)
    secs = (time.perf_counter() - t0) / times
    return _result(secs, times, "chained", detail)
