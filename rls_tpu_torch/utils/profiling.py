"""Profiling / tracing helpers.

PyTorch counterpart of ``rls_tpu/utils/profiling.py``:

  * `trace(logdir)`: a context manager around ``torch.profiler`` (the
    CPU, and the card where there is one) that writes a Chrome trace,
    ``logdir/trace.json``, viewable in Perfetto or chrome://tracing;
  * `time_solver`: time ``solve_fn(*args, **kwargs)`` over `reps` runs,
    the device synchronized around each; ``compile_s`` is the first call's
    time (kernel builds, cuFFT plans and the like land there).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import torch
from torch.profiler import ProfilerActivity, profile

__all__ = ["trace", "time_solver"]


@contextlib.contextmanager
def trace(logdir: str):
    """``with trace('traces/run'): solve(...)`` writes the run's trace to
    ``traces/run/trace.json``; yields the profiler."""
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        _sync()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_solver(solve_fn: Callable, *args, reps: int = 3, **kwargs) -> dict:
    """Run, then time `solve_fn(*args, **kwargs)` over `reps` runs.
    Returns {"compile_s", "mean_s", "per_rep_s"}."""
    _sync()
    t0 = time.perf_counter()
    solve_fn(*args, **kwargs)
    _sync()
    compile_s = time.perf_counter() - t0

    times = []
    for _ in range(reps):
        _sync()
        t0 = time.perf_counter()
        solve_fn(*args, **kwargs)
        _sync()
        times.append(time.perf_counter() - t0)
    return {
        "compile_s": compile_s,
        "mean_s": sum(times) / len(times),
        "per_rep_s": times,
    }
