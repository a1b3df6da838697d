"""Milliseconds a call that ``SamSummary.evaluate_movie`` spends in the
image encoder on the device: the program's stage ``sam.encoder``, timed by
CUDA events around its work (its counter ``sam.encoder.device_ms``), the
mean over the traced window's calls (program span)."""

import statistics

from cardbench.harness.program_counters import window_counts


def read(ctx):
    got = [c.value for c in window_counts(ctx) or []
           if c.name == "sam.encoder.device_ms"]
    return statistics.fmean(got) if got else None
