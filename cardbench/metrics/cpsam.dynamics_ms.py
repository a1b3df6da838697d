"""Milliseconds a call that ``CellposeSummary.evaluate_movie`` spends in
Cellpose's flow dynamics (the program's span ``cellpose.dynamics``: the
Euler steps, the seeds and masks, the flow check, the hole filling), the
mean over the traced window's calls (program span)."""

from cardbench.harness.program_spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "cellpose.dynamics")
