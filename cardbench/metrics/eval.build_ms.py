"""Milliseconds a call that ``evaluate_movie`` spends building its inference
net off the weights (the program's span ``evaluate_movie.build``: ``UNet2DS``
drawn, weights loaded and copied to the card, folded), the mean over the
traced window's calls (program span)."""

from cardbench.harness.program_spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "evaluate_movie.build")
