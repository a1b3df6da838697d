"""Nanoseconds the Euler steps take a followed pixel: the program's spans
``cellpose.follow_flows`` summed over the traced window, over the sum of
its counter ``cellpose.fg_px`` there (program counter)."""

from cardbench.harness import program_counters
from cardbench.harness.program_spans import window_spans


def read(ctx):
    px = program_counters.total(ctx, "cellpose.fg_px")
    spans = [s for s in window_spans(ctx) or []
             if s.name == "cellpose.follow_flows"]
    if not px or not spans:
        return None
    return sum(s.t1 - s.t0 for s in spans) / px
