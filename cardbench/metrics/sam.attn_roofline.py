"""The attention kernel in the Segment Anything encoder against its bound:
every call's attention FLOPs at SAM's two shapes (28 window blocks of 25
windows of 14 x 14 tokens, 4 global blocks of 64 x 64 tokens; per head
4 N^2 d + 2 N (gh + gw) d, ``reference/sam.py::attention_flops``) at the
bf16 peak, over the device time of the kernel ``attention_bf16_kernel``
(device trace)."""

from cardbench.reference import sam


def read(ctx):
    c, tr, y = ctx.counts, ctx.trace, ctx.yard
    if tr is None or not c.get("calls"):
        return None
    spent = tr.seconds("attention_bf16_kernel")
    if spent <= 0:
        return None
    bound = sam.attention_flops(ctx.config) / y.BF16_FLOPS_PER_S
    return 100.0 * c["calls"] * bound / spent
