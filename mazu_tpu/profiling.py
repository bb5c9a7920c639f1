"""Profiling / timing helpers (SURVEY §5: the reference only has ad-hoc
Instant timing in its CLIs; the device equivalents are jax profiler traces
and ns-per-query reporting with robust device synchronization)."""

from __future__ import annotations

import contextlib
import time

import numpy as np


def sync(x):
    """Robust device sync: fetch (a tiny reduction of) the result."""
    import jax

    return jax.device_get(x)


def time_fn(fn, *args, iters: int = 10, warmup: int = 1):
    """(seconds_per_call, last_result) with device_get synchronization."""
    for _ in range(warmup):
        sync(fn(*args))
    t = time.time()
    r = None
    for _ in range(iters):
        r = fn(*args)
    out = sync(r)
    return (time.time() - t) / iters, out


def ns_per_query(fn, queries, iters: int = 10) -> float:
    dt, _ = time_fn(fn, queries, iters=iters)
    return dt / max(1, np.shape(queries)[0]) * 1e9


@contextlib.contextmanager
def trace(logdir: str = "/tmp/mazu_tpu_trace"):
    """jax profiler trace context (view with tensorboard / xprof)."""
    import jax

    try:
        jax.profiler.start_trace(logdir)
        yield logdir
    finally:
        try:
            jax.profiler.stop_trace()
        except Exception:
            pass
