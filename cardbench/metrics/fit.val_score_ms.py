"""Milliseconds an epoch spends scoring the validation views on the host
(the program's span ``fit.validate.score``: ``nf_mask_metrics`` of every view),
the mean over the traced window's epochs (program span)."""

from cardbench.harness.program_spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "fit.validate.score")
