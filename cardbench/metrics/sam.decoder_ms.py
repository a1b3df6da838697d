"""Milliseconds a call that ``SamSummary.evaluate_movie`` spends in the
mask decoder on the device, all batches of prompts: the program's stage
``sam.decoder``, timed by CUDA events around its work (its counter
``sam.decoder.device_ms``), the mean over the traced window's calls
(program span)."""

import statistics

from cardbench.harness.program_counters import window_counts


def read(ctx):
    got = [c.value for c in window_counts(ctx) or []
           if c.name == "sam.decoder.device_ms"]
    return statistics.fmean(got) if got else None
