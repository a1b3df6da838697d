"""Profiling hooks: a ``torch.profiler`` trace around a block, the
program's spans, and per-phase throughput counters.

Port of ``deepcalcium_tpu.utils.profiling`` (``trace``, ``annotate``,
``ThroughputMeter``):
``trace`` is a no-op when no directory is given, so callers can always wrap.

``span(name)`` is the program's one span primitive, in place of the JAX
package's ``annotate``. Its switch is the profiler itself: a span records
only while a ``torch.profiler`` profile is active in the process (a
``fit(profile_dir=)`` epoch, a benchmark's traced window), and is a shared
no-op context otherwise, so the wrappers can always wrap. A recorded span
keeps its name, its start and end in ``time.time_ns`` nanoseconds (the
clock the profiler stamps its events in), its parent, its root (the
outermost span of the same call, shared by every span of that call) and
its thread, in a bounded in-memory buffer that ``recorded(t0_ns, t1_ns)``
reads. It also opens ``torch.profiler.record_function(name)``, so that a
profiler trace shows the phases. A profile of the CUDA activity alone
holds no device event named after a span; with the CPU activity on too,
the innermost span around a launch also shows as a CUDA-typed
``gpu_user_annotation`` event, which a reader that sums device time must
leave out.

``count(name, value)`` is the program's counter, beside ``span``: under
the same switch it records a number (pixels followed, masks kept) with
its time and the innermost open span of its thread as its parent, into
the same buffer, which ``counted(t0_ns, t1_ns)`` reads; ``recorded``
returns spans only.
"""

import collections
import contextlib
import itertools
import threading
import time
from typing import NamedTuple

import torch
import torch.autograd.profiler as _autograd_profiler

__all__ = ["trace", "span", "recorded", "recording", "Span", "count",
           "counted", "Count", "ThroughputMeter"]


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


class Span(NamedTuple):
    """One recorded span: times in ``time.time_ns`` nanoseconds; ``parent``
    is None for a root, whose ``root`` is its own ``id``."""
    name: str
    t0: int
    t1: int
    id: int
    parent: int | None
    root: int
    thread: int


class Count(NamedTuple):
    """One recorded counter: ``t`` in ``time.time_ns`` nanoseconds;
    ``parent`` and ``root`` are those of the innermost span open on its
    thread, or None outside any span."""
    name: str
    value: float
    t: int
    parent: int | None
    root: int | None
    thread: int


# The most spans and counts kept; the oldest go first. A traced benchmark
# window records a few thousand.
CAPACITY = 1 << 16
_spans: collections.deque = collections.deque(maxlen=CAPACITY)
_ids = itertools.count(1)
_open = threading.local()   # each thread's stack of (id, root) of open spans
_OFF = contextlib.nullcontext()


class _Recording:
    __slots__ = ("name", "id", "parent", "root", "t0", "rf")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.rf = torch.profiler.record_function(self.name)
        self.t0 = time.time_ns()
        self.rf.__enter__()
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self.id = next(_ids)
        self.parent, self.root = stack[-1] if stack else (None, self.id)
        stack.append((self.id, self.root))
        return self

    def __exit__(self, *exc):
        try:
            self.rf.__exit__(*exc)
        finally:
            t1 = time.time_ns()
            _open.stack.pop()
            # deque.append is atomic: the prefetch thread may record too.
            _spans.append(Span(self.name, self.t0, t1, self.id, self.parent,
                               self.root, threading.get_ident()))
        return False


def recording() -> bool:
    """Whether spans and counts record now: a ``torch.profiler`` profile
    is active in the process."""
    return bool(_autograd_profiler._is_profiler_enabled)


def span(name: str):
    """A context that records the enclosed block as the span ``name`` while
    a ``torch.profiler`` profile is active in the process, and does
    nothing otherwise. The process-wide flag is read, not the per-thread
    one, which reads False on threads the profiler did not start on."""
    if not recording():
        return _OFF
    return _Recording(name)


def recorded(t0_ns: int, t1_ns: int) -> list[Span]:
    """The recorded spans that lie in [t0_ns, t1_ns], oldest end first."""
    return [s for s in tuple(_spans)
            if type(s) is Span and s.t0 >= t0_ns and s.t1 <= t1_ns]


def count(name: str, value) -> None:
    """Record ``value`` under ``name`` while a ``torch.profiler`` profile
    is active in the process (the switch of :func:`span`); do nothing
    otherwise."""
    if not recording():
        return
    stack = getattr(_open, "stack", None)
    parent, root = stack[-1] if stack else (None, None)
    _spans.append(Count(name, float(value), time.time_ns(), parent, root,
                        threading.get_ident()))


def counted(t0_ns: int, t1_ns: int) -> list[Count]:
    """The recorded counts taken in [t0_ns, t1_ns], oldest first."""
    return [c for c in tuple(_spans)
            if type(c) is Count and t0_ns <= c.t <= t1_ns]


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
