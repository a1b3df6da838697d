"""Milliseconds a call that ``evaluate_movie`` spends drawing a fresh
``UNet2DS`` on the host before the weights are loaded into it (the program's
spans ``net.init`` under the root ``evaluate_movie``), summed over the traced
window and divided by its calls (program span)."""

from cardbench.harness.program_spans import per_root_ms


def read(ctx):
    return per_root_ms(ctx, "net.init", "evaluate_movie")
