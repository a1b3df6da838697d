"""What the per-layer metrics read of the measured program's own spans
(``deepcalcium_torch.utils.profiling.span``), which the program records
only while the traced window's profiler runs.

Every function takes a reader's context and returns None where there is
nothing to read: an untraced run, or a program that records no spans (one
older than the span primitive, whose ``profiling`` has no ``recorded``).
Nothing here adds to the harness's own spans (``ctx.spans``)."""

import heapq
import statistics
from collections import defaultdict

import numpy as np


def window_spans(ctx):
    """The program's spans that lie in the traced window, or None."""
    if ctx.trace is None:
        return None
    from deepcalcium_torch.utils import profiling

    recorded = getattr(profiling, "recorded", None)
    if recorded is None:
        return None
    return recorded(ctx.trace.t0, ctx.trace.t1) or None


def _ms(s):
    return (s.t1 - s.t0) / 1e6


def _durations_ms(ctx, name):
    return [_ms(s) for s in window_spans(ctx) or [] if s.name == name]


def mean_ms(ctx, name):
    """Mean duration of the spans ``name`` (one a call or an epoch)."""
    got = _durations_ms(ctx, name)
    return statistics.fmean(got) if got else None


def median_ms(ctx, name):
    """Median duration of the spans ``name`` (one a step)."""
    got = _durations_ms(ctx, name)
    return statistics.median(got) if got else None


def per_root_ms(ctx, name, root):
    """The spans ``name`` under roots named ``root``, summed, over the
    number of those roots: milliseconds a call."""
    spans = window_spans(ctx) or []
    roots = {s.id for s in spans if s.parent is None and s.name == root}
    if not roots:
        return None
    return sum(_ms(s) for s in spans
               if s.name == name and s.root in roots) / len(roots)


def idle_split(trace, items):
    """Idle device seconds of the window summed by the innermost (the
    shortest, the first of equals) of ``items``, (name, t0, t1) triples,
    that covers them, and "outside" where none does: what
    ``Trace.idle_by_span`` gives, with every name, in one sweep over the
    spans' ends instead of a loop over every gap (a traced window holds
    10^5 gaps and 10^3 spans)."""
    t0, t1 = trace.t0, trace.t1
    busy = trace.intervals
    # Busy nanoseconds before each point, from the merged intervals.
    before = np.concatenate([[0], np.cumsum(busy[:, 1] - busy[:, 0])])

    def busy_upto(x):
        i = int(np.searchsorted(busy[:, 0], x, side="right"))
        if i == 0:
            return 0
        return int(before[i - 1]) + min(x, int(busy[i - 1, 1])) - int(
            busy[i - 1, 0])

    order = sorted(range(len(items)),
                   key=lambda k: items[k][2] - items[k][1])
    rank = {k: r for r, k in enumerate(order)}
    events = []
    for k, (_, s0, s1) in enumerate(items):
        s0, s1 = max(s0, t0), min(s1, t1)
        if s0 < s1:
            events.append((s0, 1, k))
            events.append((s1, 0, k))
    events.sort()
    out = defaultdict(float)
    heap, closed = [], set()
    prev = t0
    for x, opening, k in events + [(t1, 0, None)]:
        if x > prev:
            while heap and heap[0][1] in closed:
                heapq.heappop(heap)
            idle = (x - prev) - (busy_upto(x) - busy_upto(prev))
            name = items[heap[0][1]][0] if heap else "outside"
            out[name] += idle / 1e9
            prev = x
        if k is None:
            break
        if opening:
            heapq.heappush(heap, (rank[k], k))
        else:
            closed.add(k)
    return {k: v for k, v in out.items() if v > 0}


def idle_unattributed_pct(ctx):
    """Share of the window's idle device time that no program span but a
    root covers: the idle time the spans below the entry points leave
    unexplained, the harness's loop around the calls included."""
    tr = ctx.trace
    spans = window_spans(ctx)
    if tr is None or spans is None or tr.busy_s <= 0:
        return None
    idle = tr.window_s - tr.busy_s
    if idle <= 0:
        return None
    split = idle_split(tr, [(s.name, s.t0, s.t1) for s in spans
                            if s.parent is not None])
    return 100.0 * split.get("outside", 0.0) / idle
