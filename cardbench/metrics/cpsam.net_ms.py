"""Milliseconds a call that ``CellposeSummary.evaluate_movie`` spends in the
net (the program's span ``cellpose.net``: the tiles, the ViT-L forward in
batches, the taper blend, up to the count of foreground pixels), the mean
over the traced window's calls (program span)."""

from cardbench.harness.program_spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "cellpose.net")
