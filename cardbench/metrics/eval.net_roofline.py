"""The net and glue of the evaluate calls against their roofline: the least
time of every call's 8-view forward and glue (its FLOPs at the bf16 peak,
or its irreducible bytes at the HBM bandwidth, the larger) over the device
time of every kernel the window ran except K1's ``summary_kernel``
(device trace). The same work is counted whatever kernels implement it."""


def read(ctx):
    c, tr, y = ctx.counts, ctx.trace, ctx.yard
    if tr is None or not c.get("calls"):
        return None
    spent = tr.seconds() - tr.seconds("summary_kernel")
    if spent <= 0:
        return None
    views = 8 if ctx.traffic["tta"] else 1
    bound = c["calls"] * y.eval_net_bound_s(ctx.config, ctx.traffic["window"],
                                            views)
    return 100.0 * bound / spent
