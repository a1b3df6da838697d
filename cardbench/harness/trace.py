"""The benchmark's own spans on the host, and the reduction of a
``torch.profiler`` trace of the measured window to what the per-layer
metrics read: the device's busy seconds, kernel seconds by name, and the
idle gaps by the span the host was in.

Spans and the profiler's events share one clock: the profiler stamps its
events in nanoseconds of the system clock, which ``time.time_ns`` reads."""

import contextlib
import time
from collections import defaultdict

import numpy as np


class Spans:
    """Named host intervals in nanoseconds of ``time.time_ns``."""

    def __init__(self):
        self.items = []

    @contextlib.contextmanager
    def __call__(self, name):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.items.append((name, t0, time.time_ns()))

    def add(self, name, t0, t1):
        self.items.append((name, t0, t1))


class Trace:
    """The device's activity in the window [t0, t1] (ns)."""

    def __init__(self, t0, t1):
        self.t0, self.t1 = t0, t1
        self.window_s = (t1 - t0) / 1e9
        self.by_name = defaultdict(float)   # seconds a name, every op
        self.counts = defaultdict(int)
        self.intervals = np.zeros((0, 2), np.int64)

    @classmethod
    def from_profiler(cls, prof, t0, t1):
        """Device ops (kernels, copies, sets) of a finished
        ``torch.profiler.profile``, read from its raw events."""
        tr = cls(t0, t1)
        starts, ends = [], []
        for e in prof.profiler.kineto_results.events():
            if e.device_type().name != "CUDA":
                continue
            s = e.start_ns()
            d = e.duration_ns()
            starts.append(s)
            ends.append(s + d)
            name = e.name()
            tr.by_name[name] += d / 1e9
            tr.counts[name] += 1
        if starts:
            iv = np.stack([np.asarray(starts, np.int64),
                           np.asarray(ends, np.int64)], axis=1)
            iv = np.clip(iv, t0, t1)
            tr.intervals = _merge(iv[iv[:, 1] > iv[:, 0]])
        return tr

    @property
    def busy_s(self):
        return float((self.intervals[:, 1] - self.intervals[:, 0]).sum()) / 1e9

    def seconds(self, match=None, kernels_only=True):
        """Device seconds of the ops whose name holds ``match`` (all when
        None); copies and sets are left out with ``kernels_only``."""
        return sum(s for n, s in self.by_name.items()
                   if (match is None or match in n)
                   and not (kernels_only and n.startswith(("Memcpy", "Memset"))))

    def top_ops(self, n=10):
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:120], float(s)] for name, s in ops]

    def idle_by_span(self, spans, n=10):
        """Idle device seconds of the window, summed by the innermost host
        span that covers them ("outside" where none does)."""
        gaps = []
        prev = self.t0
        for s, e in self.intervals:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if prev < self.t1:
            gaps.append((prev, self.t1))
        # Innermost first: the shortest span that covers a point.
        items = sorted(spans.items, key=lambda it: it[2] - it[1])
        out = defaultdict(float)
        for g0, g1 in gaps:
            rest = [(g0, g1)]
            for name, s0, s1 in items:
                nxt = []
                for a, b in rest:
                    lo, hi = max(a, s0), min(b, s1)
                    if lo < hi:
                        out[name] += (hi - lo) / 1e9
                        if a < lo:
                            nxt.append((a, lo))
                        if hi < b:
                            nxt.append((hi, b))
                    else:
                        nxt.append((a, b))
                rest = nxt
                if not rest:
                    break
            for a, b in rest:
                out["outside"] += (b - a) / 1e9
        return [[k, float(v)] for k, v in sorted(out.items(), key=lambda kv: -kv[1])[:n]]


def _merge(iv):
    """Union of [start, end) intervals, sorted."""
    if len(iv) == 0:
        return iv
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), bool)
    new[1:] = iv[1:, 0] > ends[:-1]
    starts = iv[new, 0]
    idx = np.flatnonzero(new)
    last = np.append(idx[1:] - 1, len(iv) - 1)
    return np.stack([starts, ends[last]], axis=1)


@contextlib.contextmanager
def profiled(enabled, on_card=True):
    """``torch.profiler`` on the CUDA activity (the CPU's off the card)
    around the block, or nothing; yields a holder whose ``prof`` is the
    finished profile."""
    holder = type("Held", (), {"prof": None})()
    if not enabled:
        yield holder
        return
    from torch.profiler import ProfilerActivity, profile

    activity = ProfilerActivity.CUDA if on_card else ProfilerActivity.CPU
    with profile(activities=[activity]) as prof:
        yield holder
    holder.prof = prof
