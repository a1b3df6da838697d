"""Milliseconds a spike ``predict`` call spends building its net off the
weights (the program's span ``predict.build``: ``UNet1D`` drawn, weights loaded
and copied to the card, folded), the mean over the traced window's calls
(program span)."""

from cardbench.harness.program_spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "predict.build")
