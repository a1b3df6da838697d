"""The evaluate calls' share of the card's bf16 peak: the frozen FLOPs of
the 8-view forward of every movie done, over the traced window's wall
time (host clock)."""


def read(ctx):
    c, y = ctx.counts, ctx.yard
    if not c.get("calls") or not c.get("window_s"):
        return None
    h, w = ctx.traffic["window"]
    views = 8 if ctx.traffic["tta"] else 1
    flops = c["calls"] * views * y.forward_flops(ctx.config, h, w)
    return 100.0 * flops / c["window_s"] / y.BF16_FLOPS_PER_S
