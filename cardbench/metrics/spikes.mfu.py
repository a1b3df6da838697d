"""The spike predict calls' share of the card's bf16 peak: the frozen
forward FLOPs a sample (of a 4096-sample window) x the samples done, over
the traced window's wall time (host clock)."""


def read(ctx):
    c, y = ctx.counts, ctx.yard
    if not c.get("samples") or not c.get("window_s"):
        return None
    per_sample = y.forward_flops(ctx.config, 4096) / 4096
    return 100.0 * per_sample * c["samples"] / c["window_s"] / y.BF16_FLOPS_PER_S
