"""Profiling hook: a ``torch.profiler`` trace around a block.

Port of ``deepcalcium_tpu.utils.profiling.trace``: a no-op when no
directory is given, so callers can always wrap.
"""

import contextlib

import torch

__all__ = ["trace"]


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
