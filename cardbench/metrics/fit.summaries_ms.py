"""Milliseconds a ``fit`` call spends on the series and mask summaries of
every dataset (the program's span ``fit.summaries``), the mean over the
traced window's calls (program span)."""

from cardbench.harness.program_spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "fit.summaries")
