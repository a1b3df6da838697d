"""Milliseconds an epoch spends writing its checkpoint (the program's span
``fit.checkpoint``: the weights to the JAX layout and ``save_checkpoint``), the
mean over the traced window's epochs (program span)."""

from cardbench.harness.program_spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "fit.checkpoint")
