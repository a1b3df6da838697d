"""The Cellpose-SAM net against its roofline: the least time of every
call's tiles (their FLOPs at the bf16 peak, or their irreducible bytes at
the HBM bandwidth, the larger; ``reference/cellpose_sam.py``) over the
device time of every kernel the window ran except K1's
``summary_kernel`` (device trace). The same work is counted whatever
kernels implement it; the dynamics' kernels are in the denominator."""

from cardbench.reference import cellpose_sam


def read(ctx):
    c, tr, y = ctx.counts, ctx.trace, ctx.yard
    if tr is None or not c.get("calls") or not c.get("tiles"):
        return None
    spent = tr.seconds() - tr.seconds("summary_kernel")
    if spent <= 0:
        return None
    per_call = c["tiles"] // c["calls"]
    bound = max(per_call * cellpose_sam.forward_flops(ctx.config)
                / y.BF16_FLOPS_PER_S,
                cellpose_sam.forward_bytes(ctx.config, per_call)
                / y.HBM_BYTES_PER_S)
    return 100.0 * c["calls"] * bound / spent
