"""The Segment Anything evaluate calls' share of the card's bf16 peak: the
frozen FLOPs of every call's encoder and 1,024 prompts' decoder
(``reference/sam.py``) over the traced window's wall time (host clock)."""

from cardbench.reference import sam


def read(ctx):
    c, y = ctx.counts, ctx.yard
    if not c.get("calls") or not c.get("window_s"):
        return None
    flops = c["calls"] * sam.forward_flops(ctx.config)
    return 100.0 * flops / c["window_s"] / y.BF16_FLOPS_PER_S
