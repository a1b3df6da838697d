"""Milliseconds an epoch spends in the validation forward of every view
(the program's span ``fit.validate.forward``: ``predict_batched``, its copies in
and out), the mean over the traced window's epochs (program span)."""

from cardbench.harness.program_spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "fit.validate.forward")
