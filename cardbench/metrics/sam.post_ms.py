"""Milliseconds a call that ``SamSummary.evaluate_movie`` spends on the
device in the mask generator's steps after the decoder: the masks resized,
the filters and boxes (``sam.postprocess``), box NMS (``sam.nms``) and the
label image (``sam.labels``), each stage timed by CUDA events around its
work (the counters ``<stage>.device_ms``); the sum of their means over the
traced window's calls (program span)."""

import statistics

from cardbench.harness.program_counters import window_counts

STAGES = ("sam.postprocess", "sam.nms", "sam.labels")


def read(ctx):
    counts = window_counts(ctx) or []
    got = [[c.value for c in counts if c.name == name + ".device_ms"]
           for name in STAGES]
    return sum(statistics.fmean(v) for v in got) if all(got) else None
