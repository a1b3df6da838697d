"""Profiling hooks: a ``torch.profiler`` trace around a block, and
per-phase throughput counters.

Port of ``deepcalcium_tpu.utils.profiling`` (``trace``, ``annotate``,
``ThroughputMeter``):
``trace`` is a no-op when no directory is given, so callers can always wrap.
"""

import contextlib
import time

import torch

__all__ = ["trace", "annotate", "ThroughputMeter"]


@contextlib.contextmanager
def trace(log_dir: str | None):
    """Profile the enclosed block (CPU, and CUDA when a card is present)
    into a Chrome/TensorBoard trace under ``log_dir``; no-op when None."""
    if not log_dir:
        yield
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


@contextlib.contextmanager
def annotate(name: str):
    """Named sub-span inside an active profiler trace."""
    with torch.profiler.record_function(name):
        yield


class ThroughputMeter:
    """Accumulate per-phase item counts and wall time; report rates."""

    def __init__(self):
        self._items: dict[str, float] = {}
        self._secs: dict[str, float] = {}

    @contextlib.contextmanager
    def track(self, phase: str, items: float):
        tic = time.perf_counter()
        yield
        self._secs[phase] = self._secs.get(phase, 0.0) + time.perf_counter() - tic
        self._items[phase] = self._items.get(phase, 0.0) + items

    def rates(self) -> dict:
        """Items per second of each phase."""
        return {k: (self._items[k] / self._secs[k] if self._secs[k] > 0 else 0.0)
                for k in self._items}
