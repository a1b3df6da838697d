"""The measured ``fit``'s training share of the card's bf16 peak: 3 x the
frozen forward FLOPs of a training window (forward and backward) x the
windows trained, over the wall time of the ``fit`` call (host clock)."""


def read(ctx):
    c, y = ctx.counts, ctx.yard
    if not c.get("windows") or not c.get("window_s"):
        return None
    flops = 3 * c["windows"] * y.forward_flops(ctx.config, *c["window_shape"])
    return 100.0 * flops / c["window_s"] / y.BF16_FLOPS_PER_S
