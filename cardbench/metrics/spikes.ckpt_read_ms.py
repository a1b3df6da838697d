"""Milliseconds a spike ``predict`` call spends reading its checkpoint (the
program's span ``predict.ckpt_read``), the mean over the traced window's
calls (program span)."""

from cardbench.harness.program_spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "predict.ckpt_read")
