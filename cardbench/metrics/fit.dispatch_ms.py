"""Milliseconds a training step spends in the step call on the host (the
program's span ``fit.step``: the eager step enqueued, and the EMA update where
there is one), the median over the traced window's steps, whose first three
carry the harness's capture hooks (program span)."""

from cardbench.harness.program_spans import median_ms


def read(ctx):
    return median_ms(ctx, "fit.step")
