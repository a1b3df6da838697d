"""Milliseconds a training step waits for the prefetch thread's next batch
(the program's span ``fit.prefetch_wait``), the median over the traced
window's steps (program span)."""

from cardbench.harness.program_spans import median_ms


def read(ctx):
    return median_ms(ctx, "fit.prefetch_wait")
