"""Kernel K1 (``csrc/summary.cu``) against its roofline: the bytes each
summary has to move (the int16 movie read once, the float32 mean and max
written once) at the HBM bandwidth, over the device time of the kernels
named ``summary_kernel`` (device trace)."""


def read(ctx):
    c, tr, y = ctx.counts, ctx.trace, ctx.yard
    if tr is None or not c.get("frames"):
        return None
    spent = tr.seconds("summary_kernel")
    if spent <= 0:
        return None
    h, w = c["frame_hw"]
    nbytes = sum(y.k1_bytes(t, h, w) for t in c["frames"])
    return 100.0 * nbytes / y.HBM_BYTES_PER_S / spent
