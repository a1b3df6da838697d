"""The Cellpose-SAM evaluate calls' share of the card's bf16 peak: the
frozen FLOPs of every tile's forward (``reference/cellpose_sam.py``) over
the traced window's wall time (host clock)."""

from cardbench.reference import cellpose_sam


def read(ctx):
    c, y = ctx.counts, ctx.yard
    if not c.get("tiles") or not c.get("window_s"):
        return None
    flops = c["tiles"] * cellpose_sam.forward_flops(ctx.config)
    return 100.0 * flops / c["window_s"] / y.BF16_FLOPS_PER_S
